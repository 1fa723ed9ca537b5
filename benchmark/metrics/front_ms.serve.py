"""A job's wall outside its synthesize and vocoder calls, per job (ms):
the duration pass, bucketing, padding, host copies and gathers."""


def read(ctx):
    s = ctx["spans"]
    jobs = s.times.get("job")
    if not jobs:
        return None
    rest = s.total("job") - s.total("synthesize") - s.total("vocoder")
    return 1e3 * rest / len(jobs)
