"""The check's control and planted faults, read at a cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 \\
        [--seconds 1]

For each seed one short run of the cell (its set-up, one job or its first
steps, the check), then on the same sample the control: the reference in
float8 products in the program's place (``check`` says how); for a
training cell also the reference with half of each batch left out. Prints
one JSON line a seed: the program's numbers and the control's. The
benchmark's own runs never run this; the limits in
``benchmark/limits/<cell>.json`` were set from its readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run as bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    bench.environment()
    cell, _, cfg, reference, mix = bench.cell_of(bench.manifest(),
                                                 args.workload)
    import torch
    torch.set_num_threads(bench.HOST_THREADS)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if mix["kind"] == "serve":
        from benchmark import serve as driver
    else:
        from benchmark import train as driver
    for seed in args.seeds:
        out = driver.run(reference, cfg, mix, seed, args.seconds, False,
                         torch.device("cuda", 0), time.perf_counter(),
                         control=True)
        print(json.dumps({"seed": seed, "program": out["numbers"],
                          "control": out["ctx"]["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
