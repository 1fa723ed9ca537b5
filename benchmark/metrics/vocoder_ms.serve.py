"""The wall of one bucket batch's Vocos decode (ms), each span closed by a synchronise."""


def read(ctx):
    t = ctx["spans"].times.get("vocoder")
    return 1e3 * sum(t) / len(t) if t else None
