"""The profiled stretch's floor over its device busy time (%): the sum
over the model's products of the larger of operations over the bf16 peak
and bytes over the memory bandwidth (``benchmark.work``), whatever
kernels compute them."""
from benchmark import work


def read(ctx):
    busy = ctx["profile"]["busy_s"]
    if not busy or not ctx.get("profile_ops"):
        return None
    return work.share(work.roofline_s(ctx["profile_ops"]), busy)
