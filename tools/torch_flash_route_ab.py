#!/usr/bin/env python3
"""The flash-attention route (K8) off and on in a training step (model3 or
the variant), in turns, on one CUDA card: the measurement behind
``Trainer``'s default.

    python3 tools/torch_flash_route_ab.py [--variant] [--runs 10]
                                          [--steps 5] [--warmup 1]
                                          [--out FILE]

One ``Trainer`` at ``configs/reference_parity.json`` widths (EMA on, seed
0, bf16 autocast, B=32 on loader-shaped batches, as ``chip_smoke.py``
trains; model3, or with ``--variant`` the VITS variant ``chip_smoke.py``
trains: stochastic duration predictor and residual-coupling flow) takes
``--runs`` runs a side, the route switched with
``set_use_flash`` between runs in the order off, on, on, off, ...; a run
is ``--warmup`` untimed steps and ``--steps`` timed ones (host clock
around ``train_step`` ending in a synchronise). Each run's median step is
its reading. The rule: the route goes on by default when the route-on
runs' median is at most the upper quartile of the route-off runs (inside
their interquartile range or below it: it costs no step time). Prints one
line per run, then the quartiles, the medians, the peak memory of each side
and the verdict with the card's name and power limit; ``--out`` also writes
them as JSON. Needs the card (exits 1 without one) and no network.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(sorted(xs), n=4, method="inclusive")
    return q1, q2, q3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="store_true",
                    help="the sdp + flow variant instead of model3")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_route_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from diff_vits_tpu_torch.nn.unet1d import set_use_flash
    from diff_vits_tpu_torch.ops import _cuda
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer

    card = chip_smoke.card_line()
    _cuda.build()
    cfg = (chip_smoke._train_cfg(duration_predictor="sdp", use_flow=True)
           if args.variant else chip_smoke._train_cfg())
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    batches = chip_smoke._train_batches(np, b, t_x, t_y, t_y * 2 // 3 + 1,
                                        len(symbols), seed=8)
    trainer = Trainer(cfg, batches, device=torch.device("cuda"))
    it = iter(batches)
    for _ in range(2):                       # first steps: allocator, build
        trainer.train_step(next(it))
    torch.cuda.synchronize()
    order = [(i // 2 + i % 2) % 2 == 1 for i in range(2 * args.runs)]
    runs = {False: [], True: []}
    peak = {False: 0.0, True: 0.0}
    for n, flash in enumerate(order):
        set_use_flash(trainer.model, flash)
        for _ in range(args.warmup):
            trainer.train_step(next(it))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for _ in range(args.steps):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        peak[flash] = max(peak[flash],
                          torch.cuda.max_memory_allocated() / 1e9)
        runs[flash].append(statistics.median(steps))
        print(f"run {n + 1:2d} flash {'on ' if flash else 'off'}: median "
              f"step {runs[flash][-1] * 1e3:.1f} ms of "
              f"{[round(x * 1e3, 1) for x in steps]}", flush=True)
    q_off, q_on = quartiles(runs[False]), quartiles(runs[True])
    on_by_default = q_on[1] <= q_off[2]
    res = dict(card=card, model="variant" if args.variant else "model3",
               runs=args.runs, steps=args.steps,
               warmup=args.warmup,
               off_ms=[x * 1e3 for x in runs[False]],
               on_ms=[x * 1e3 for x in runs[True]],
               off_quartiles_ms=[x * 1e3 for x in q_off],
               on_quartiles_ms=[x * 1e3 for x in q_on],
               peak_GB=dict(off=peak[False], on=peak[True]),
               on_by_default=on_by_default)
    print(f"route off: median {q_off[1] * 1e3:.1f} ms, interquartile "
          f"{q_off[0] * 1e3:.1f}-{q_off[2] * 1e3:.1f} ms, peak "
          f"{peak[False]:.2f} GB; route on: median {q_on[1] * 1e3:.1f} ms, "
          f"interquartile {q_on[0] * 1e3:.1f}-{q_on[2] * 1e3:.1f} ms, peak "
          f"{peak[True]:.2f} GB; on by default: {on_by_default}; card "
          f"{card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
