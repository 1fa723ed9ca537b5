"""The benchmark of diff_vits_tpu_torch on one card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its configuration's file (``configs``), the plain
reference and work count that file names (``benchmark.references``), its
traffic mix in ``benchmark/traffic/<traffic>.json``, the limits of its
check in ``benchmark/limits/<cell>.json`` and, with ``--trace 1``, each
per-layer metric's reader in ``benchmark/metrics/<metric>.py``. The last
line of standard output is the result, one JSON object; the numbers the
check compared, each beside its limit, are the last lines of standard
error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diff_vits_tpu")
HOST_THREADS = 2


def environment() -> None:
    """Before torch is imported: every build and kernel cache at a fixed
    path inside the checkout (the port's own kernels build into
    ``build/kernels`` there), and two host threads for the CPU's share of
    the work, so that a run's host timing does not depend on how many
    cores the machine lends it."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str):
    """(cell, its configuration entry, the configuration, its reference,
    the mix). Raises ``references.BadReference`` where the configuration
    names a reference that cannot be used."""
    from benchmark import references, traffic
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf["file"]) as f:
        cfg = json.load(f)
    return (cell, conf, cfg, references.resolve(cfg),
            traffic.load(cell["traffic"]))


def metrics_of(bench: dict, cell: dict, traced: bool):
    """The cell's metrics: its end-to-end ones, or with ``traced`` its
    per-layer ones."""
    out = []
    for m in bench["per_layer" if traced else "end_to_end"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            out.append(m)
    return out


def reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    bench = manifest()
    from benchmark.references import BadReference
    try:
        cell, _, cfg, reference, mix = cell_of(bench, args.workload)
    except BadReference as e:
        print(e, file=sys.stderr)
        return 2

    import torch
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from benchmark import check, trace
    if mix["kind"] == "serve":
        from benchmark import serve as driver
    else:
        from benchmark import train as driver
    out = driver.run(reference, cfg, mix, args.seed, args.seconds,
                     bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3

    with open(HERE / "limits" / f"{cell['name']}.json") as f:
        limits = json.load(f)["limits"]
    numbers = out["numbers"]
    correct = check.verdict(numbers, limits) and out["failed"] == 0
    compared = check.report(numbers, limits)
    values = {}
    for m in metrics_of(bench, cell, bool(args.trace)):
        v = (out["end_to_end"].get(m["name"]) if not args.trace
             else reader(m["name"])(out["ctx"]))
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device_key = trace.device_info(device, cell["chips"])
    device_key["memory_peak_bytes"] = out["peak"]
    device_key["power"] = trace.power_limit()
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": values,
              "device": device_key}
    if args.trace:
        prof = out["ctx"]["profile"]
        device_key["busy_s"] = prof["busy_s"]
        device_key["window_s"] = prof["window_s"]
        # kernel names cut to 160 characters (templated names run to
        # thousands)
        result["breakdown"] = {
            k: [[name[:160], v] for name, v in prof[k]]
            for k in ("device_ops", "idle_gaps")}
    result["compared"] = compared
    print("numbers not compared: " + json.dumps(
        {k: v for k, v in sorted(numbers.items()) if k not in compared}),
        file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"{k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
