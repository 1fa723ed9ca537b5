"""The wall of one VITS.infer call (text encoder, durations, expansion,
flow, o_proj), per synthesize call (ms), each span closed by a
synchronise."""


def read(ctx):
    t = ctx["spans"].times.get("prior")
    return 1e3 * sum(t) / len(t) if t else None
