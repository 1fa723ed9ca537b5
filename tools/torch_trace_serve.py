#!/usr/bin/env python3
"""What the port's tracer (``diff_vits_tpu_torch/core/trace.py``) reads in
a serving cell of the benchmark, before the harness reads it itself.

    python3 tools/torch_trace_serve.py --workload model3-serve-b64 \\
        --seed N [--seconds 30] [--cost 2] [--out FILE] [--trace_out FILE]

Runs ``python3 -m benchmark.run --trace 1`` in this process with its
traced stretch changed in two ways: the tracer is on, with CUDA events,
over the job the benchmark's own spans time (each of their spans closed by
a synchronise) and over the profiled job, and each job's spans and
counters are collected after it; and before the profiled job the same job
runs ``--cost`` pairs of times with the tracer off and on in turns (host
clock, each run ending in a synchronise: what the tracer costs when on).
The profiled job's every idle gap goes to the innermost span open over it
(``benchmark/trace_idle.py``). The extra jobs enter the run's own
readings (``frame_fill.serve`` counts their calls).

Prints the benchmark's result line, then one JSON line of readings:
``denoise_host_ms`` and ``denoise_dev_ms`` (a UNet call's host time from
entering ``dvt.denoise`` to its return, and its device time between the
span's events) in the spans' job and in the profiled job, ``noise_idle_ms``
(device idle inside ``dvt.noise`` a ``dvt.synthesize``) and
``front_idle_ms`` (inside ``dvt.front.*`` a job) in the profiled job,
``row_fill`` and the counters' frame fill, ``ph_vae_host_ms`` /
``ph_vae_dev_ms`` and ``flow_host_ms`` / ``flow_dev_ms`` (the phoneme
VAE's ``dvt.ph_vae`` and the spec flow's ``dvt.flow``, a call, where the
configuration has them) and ``ph_vae_fill`` (the VAE's real tokens over
batch x text bucket), idle seconds by span, the share
of the gaps' idle under spans below ``dvt.job``, the launches a UNet call
and the on-cost. ``--trace_out`` exports the spans' job as Chrome-trace
JSON.
"""
import argparse
import contextlib
import io
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run, trace_idle  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--cost", type=int, default=2)
    p.add_argument("--out", default=None)
    p.add_argument("--trace_out", default=None)
    args = p.parse_args(argv)
    bench_run.environment()
    jobs, cost, idle = install(args.cost)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "1"])
    line = buf.getvalue().strip().splitlines()[-1] if buf.getvalue() else ""
    print(line)
    if rc != 0 or len(jobs) != 2:
        print(f"run exited {rc} with {len(jobs)} traced jobs",
              file=sys.stderr)
        return rc or 1
    if args.trace_out:
        from diff_vits_tpu_torch.core import trace as dvt
        dvt.export(args.trace_out, jobs[0])
    readings = {"workload": args.workload, "seed": args.seed,
                "result": json.loads(line)}
    readings.update(read(jobs, idle, cost))
    text = json.dumps(readings)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


def install(pairs: int):
    """Change the benchmark's traced stretch as the module's docstring
    says. Returns the lists and dict it fills: each traced job's
    collection, the on / off runs, the profiled job's idle by span."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from benchmark import trace as btrace
    from diff_vits_tpu_torch.core import trace as dvt

    jobs, cost, idle = [], [], {}

    class Spans(btrace.Spans):
        """The benchmark's spans, with the tracer on from the first time
        they are and collected each time they go off."""

        @property
        def on(self):
            return self._on

        @on.setter
        def on(self, value):
            self._on = value
            if value:
                dvt.enable()
            elif dvt.enabled():
                jobs.append(dvt.collect())

    def profile(fn, device):
        for i in range(pairs):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                (dvt.enable if on else dvt.disable)()
                btrace.sync(device)
                t0 = time.perf_counter()
                fn()
                btrace.sync(device)
                wall = time.perf_counter() - t0
                cost.append({"on": on, "wall_s": wall,
                             "spans": len(dvt.collect()["spans"])})
        dvt.enable()
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        btrace.sync(device)
        with tprofile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            btrace.sync(device)
            wall = time.perf_counter() - t0
        jobs.append(dvt.collect())
        dvt.disable()
        dev, host = btrace._split_events(prof.profiler.kineto_results.events())
        idle.update(trace_idle.idle_by_span(dev, host))
        return out, btrace.reduce_events(dev, host, wall)

    btrace.Spans, btrace.profile = Spans, profile
    return jobs, cost, idle


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return statistics.fmean(xs) if xs else None


def read(jobs, idle, cost):
    """The readings of the spans' job and the profiled job (``jobs``), the
    profiled job's idle by span, and the on / off pairs."""
    out = {}
    for key, got in zip(("spans_job", "profiled_job"), jobs):
        den = [s for s in got["spans"] if s["name"] == "dvt.denoise"]
        out[key] = {
            **_per_call(got["spans"], "dvt.denoise", "denoise"),
            **_per_call(got["spans"], "dvt.ph_vae", "ph_vae"),
            **_per_call(got["spans"], "dvt.flow", "flow"),
            "launches_a_denoise": den[-1]["attrs"].get("delta") if den
            else None,
            "host_ms_by_span": _by_name(got["spans"], "host_ms"),
            "device_ms_by_span": _by_name(got["spans"], "device_ms"),
            "spans": len(got["spans"]),
            "counters": got["counters"]}
    prof = jobs[1]["spans"]
    calls = sum(s["name"] == "dvt.synthesize" for s in prof)
    n_jobs = sum(s["name"] == "dvt.job" for s in prof)
    total = sum(idle.values())
    c = [j["counters"] for j in jobs]
    out.update(
        noise_idle_ms=1e3 * idle.get("dvt.noise", 0.0) / calls,
        front_idle_ms=1e3 * sum(v for k, v in idle.items()
                                if k.startswith("dvt.front.")) / n_jobs,
        row_fill=100.0 * sum(x["serve.rows_real"] for x in c)
        / sum(x["serve.rows"] for x in c),
        frame_fill_counted=100.0 * sum(x["serve.frames_out"] for x in c)
        / sum(x["serve.frames_held"] for x in c),
        ph_vae_fill=100.0 * sum(x["ph_vae.tokens_real"] for x in c)
        / sum(x["ph_vae.tokens_held"] for x in c)
        if all("ph_vae.tokens_held" in x for x in c) else None,
        idle_s_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        gap_idle_s=total,
        below_job_share=(total - idle.get("dvt.job", 0.0)
                         - idle.get(trace_idle.OUTSIDE, 0.0)) / total
        if total else None)
    off = [r["wall_s"] for r in cost if not r["on"]]
    on = [r for r in cost if r["on"]]
    if off and on:
        extra = statistics.median(r["wall_s"] for r in on) \
            - statistics.median(off)
        out["cost"] = {"runs": cost, "on_minus_off_ms_a_job": 1e3 * extra,
                       "us_a_span": 1e6 * extra / on[0]["spans"]}
    return out


def _per_call(spans, name, key):
    """A span's mean host and device ms a call, and its calls."""
    got = [s for s in spans if s["name"] == name]
    return {f"{key}_host_ms": _mean([s["host_ms"] for s in got]),
            f"{key}_dev_ms": _mean([s["device_ms"] for s in got]),
            f"{key}_calls": len(got)}


def _by_name(spans, key):
    got = {}
    for s in spans:
        if s[key] is not None:
            got[s["name"]] = got.get(s["name"], 0.0) + s[key]
    return got


if __name__ == "__main__":
    sys.exit(main())
