"""The wall of one denoiser UNet call (ms), each span closed by a synchronise."""


def read(ctx):
    t = ctx["spans"].times.get("denoise")
    return 1e3 * sum(t) / len(t) if t else None
