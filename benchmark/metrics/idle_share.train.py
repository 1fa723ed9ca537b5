"""The share of the profiled stretch's wall in which no operation ran on
the device (%)."""


def read(ctx):
    p = ctx["profile"]
    if not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
