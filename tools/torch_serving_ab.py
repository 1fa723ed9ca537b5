#!/usr/bin/env python3
"""Serving latency of two checkouts of the port on one card, in turns.

    python3 tools/torch_serving_ab.py PARENT_DIR CHANGE_DIR [--rounds N]
                                      [--out FILE]

Runs parent, change, change, parent (N rounds of that), each in its own
process from the root of the given checkout, so each builds and imports
its own ``diff_vits_tpu_torch``: the model3 serving set-up of that
checkout's ``chip_smoke.py`` (``configs/reference_parity.json`` widths,
random weights from seed 0, ``BatchSynthesizer`` in bf16) and its
``serving_numbers``: per-request latency of ``synthesize`` at batch 1 and 8
(text bucket 128, mel bucket 400, 30 UniPC steps), the median of 3 warmed
calls; then the device busy time of one profiled ``synthesize`` at batch
8 (``profile_synthesize``: the summed device activity). Prints every run
and the median over runs per checkout and batch.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def child(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = load_config(str(root / "configs" / "reference_parity.json"))
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400, 800), dtype=torch.bfloat16,
                           device=dev)
    reqs = cs._requests(torch, torch.Generator().manual_seed(1), len(symbols),
                        syn.refer_frames)
    short = [r for r in reqs if len(r[1]) <= 128]
    numbers = cs.serving_numbers(torch, syn, short, card)
    prof = cs.profile_synthesize(
        torch, syn, [short[i % len(short)] for i in range(8)], card)
    print("RESULT " + json.dumps(dict(
        card=card, b1=numbers["b1"]["latency_s"],
        b8=numbers["b8"]["latency_s"],
        b8_busy=prof["device_busy_ms"] / 1e3)), flush=True)


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
            print(f"{name}: b=1 {res['b1'] * 1e3:.1f} ms, b=8 "
                  f"{res['b8'] * 1e3:.1f} ms, b=8 device busy "
                  f"{res['b8_busy'] * 1e3:.2f} ms; card {res['card']}",
                  flush=True)
    for name in ("parent", "change"):
        for b in ("b1", "b8", "b8_busy"):
            vals = [r[b] * 1e3 for r in runs if r["tree"] == name]
            print(f"{name} {b}: median {statistics.median(vals):.1f} ms of "
                  f"{[round(v, 1) for v in vals]}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
