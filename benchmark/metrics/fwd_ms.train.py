"""The wall of DiffVits.forward with all its losses, per step (ms), each
span closed by a synchronise."""


def read(ctx):
    t = ctx["spans"].times.get("forward")
    return 1e3 * sum(t) / len(t) if t else None
