"""Model operations of the work completed over wall x the bf16 dense peak
(%), over the traced window's first stretch, before the spans and the
profiler are turned on."""
from benchmark import work


def read(ctx):
    flops, wall = ctx["mfu"]
    return 100.0 * flops / (wall * work.PEAK_FLOPS) if wall > 0 else None
