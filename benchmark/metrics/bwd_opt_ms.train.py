"""A step's wall less its forward, per step (ms): backward, clipping,
AdamW and the EMA."""


def read(ctx):
    s = ctx["spans"]
    steps = s.times.get("step")
    if not steps:
        return None
    return 1e3 * (s.total("step") - s.total("forward")) / len(steps)
