#!/usr/bin/env python3
"""Device time of csrc/attention.cu's tensor-core kernel at the main path's
shapes under other split targets of ``ops/_cuda.attention_plan``.

    python3 tools/torch_attention_probe.py [--out FILE] [--targets 132,264,396]

For each target (the least number of blocks the plan splits the keys to
reach; the port's plan uses 132, one block an SM) and each bf16
attention-core case of ``chip_smoke.py``'s kernel phase (denoiser levels
0, 2 and mid and the duration predictor's level 0 at B=8, denoiser level 0
and mid at B=1; self and cross attention), prints the plan, the core's
mean device time over 20 warmed launches (torch.profiler, by kernel name)
and its largest error against ``attention_plain`` relative to the largest
output, then the sum over the cases. Needs one CUDA card and nvcc.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", default="132,264,396",
                    help="comma-separated block targets")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from diff_vits_tpu_torch.ops import _cuda
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _cuda.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = [c for c in cs._kernel_cases(torch, torch.bfloat16, gen, dev)
             if c[0] == "attention"]
    _, plain = cs._ops("attention")
    default = _cuda.ATTN_MIN_BLOCKS
    rows = []
    try:
        for target in (int(x) for x in a.targets.split(",")):
            _cuda.ATTN_MIN_BLOCKS = target
            total = 0.0
            for _, site, args, kw, *_ in cases:
                q, k, v, bias = args
                heads = kw["heads"]
                b, t, c = q.shape
                plan = _cuda.attention_plan(b, t, k.shape[1], heads,
                                            c // heads, q.dtype)
                out = _cuda.attention(q, k, v, bias, heads)
                ref = plain(*args, **kw)
                err = ((out.float() - ref).abs().max()
                       / ref.abs().max()).item()
                _, by_name = cs.device_times(
                    lambda: _cuda.attention(q, k, v, bias, heads), iters=20)
                us = 1e3 * cs._core_kernels(by_name)["bfloat16"]
                total += us
                rows.append(dict(target=target, site=site, rows=plan.rows,
                                 splits=plan.splits, core_us=us, rel_err=err))
                print(f"target {target:4d} {site:40s} rows {plan.rows:2d} "
                      f"splits {plan.splits} core {us:7.2f} us rel_err "
                      f"{err:.1e}", flush=True)
            print(f"target {target:4d} sum {total:.2f} us; card {card}",
                  flush=True)
    finally:
        _cuda.ATTN_MIN_BLOCKS = default
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
