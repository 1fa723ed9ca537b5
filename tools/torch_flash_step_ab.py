#!/usr/bin/env python3
"""K8's device time in model3's training step with the flash route on, for
two checkouts of the port on one card, in turns.

    python3 tools/torch_flash_step_ab.py PARENT_DIR CHANGE_DIR [--rounds N]
                                         [--out FILE]

Runs parent, change, change, parent (N rounds of that), each in its own
process from the root of the given checkout, so each builds and imports
its own ``diff_vits_tpu_torch``: a ``Trainer`` at that checkout's
``configs/reference_parity.json`` widths (its ``chip_smoke.py`` training
set-up: EMA on, seed 0, bf16 autocast, B=32 on loader-shaped batches)
with the flash route on, 2 warm-up steps, 5 timed steps (host clock
ending in a synchronise; their median) and 3 steps under torch.profiler:
per step, the device time of the K8 kernels (``dvt::flash_*``) and of all
device activity. Prints every run and the median over runs per checkout.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(root: Path) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from diff_vits_tpu_torch.nn.unet1d import set_use_flash
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer

    card = cs.card_line()
    cfg = cs._train_cfg()
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    batches = cs._train_batches(np, b, t_x, t_y, t_y * 2 // 3 + 1,
                                len(symbols), seed=8)
    trainer = Trainer(cfg, batches, device=torch.device("cuda"))
    set_use_flash(trainer.model, True)
    it = iter(batches)
    for _ in range(2):
        trainer.train_step(next(it))
    steps = []
    for _ in range(5):
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            trainer.train_step(next(it))
        torch.cuda.synchronize()
    by_name = cs.device_by_name(prof)
    k8 = {k: (c, us) for k, (c, us) in by_name.items() if "dvt::flash_" in k}
    print("RESULT " + json.dumps(dict(
        card=card, step_ms=statistics.median(steps) * 1e3,
        k8_device_ms=sum(us for _, us in k8.values()) / 1e3 / n,
        k8_launches=sum(c for c, _ in k8.values()) / n,
        busy_ms=sum(us for _, us in by_name.values()) / 1e3 / n,
        k8_kernels={k.split("(")[0]: us / 1e3 / n
                    for k, (_, us) in k8.items()})), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]).resolve())
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    runs = []
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            root = getattr(args, name).resolve()
            proc = subprocess.run([sys.executable, __file__, "--child",
                                   str(root)], cwd=root, capture_output=True,
                                  text=True, timeout=900)
            lines = [x for x in proc.stdout.splitlines()
                     if x.startswith("RESULT ")]
            if proc.returncode or not lines:
                print(f"{name}: rc {proc.returncode}\n{proc.stderr[-2000:]}")
                return 1
            res = dict(json.loads(lines[-1][7:]), tree=name)
            runs.append(res)
            print(f"{name}: step {res['step_ms']:.1f} ms, K8 device "
                  f"{res['k8_device_ms']:.3f} ms in {res['k8_launches']:.0f} "
                  f"launches, device busy {res['busy_ms']:.1f} ms a step; "
                  f"card {res['card']}", flush=True)
    for name in ("parent", "change"):
        mine = [r for r in runs if r["tree"] == name]
        for key in ("step_ms", "k8_device_ms", "busy_ms"):
            vals = [r[key] for r in mine]
            print(f"{name} {key}: median {statistics.median(vals):.3f} of "
                  f"{[round(v, 3) for v in vals]}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
