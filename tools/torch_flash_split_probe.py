#!/usr/bin/env python3
"""What it costs K8's tensor-core kernels to feed p and ds to their
products as two bfloat16 parts (hi + lo), on one CUDA card.

    python3 tools/torch_flash_split_probe.py [--rounds N] [--out FILE]

``csrc/flash_attention.cu`` multiplies each C->A fragment of p (P V, the
forward; P^T dO, the dK/dV kernel) and of ds (dS K, dS^T Q) as its hi and
lo bf16 parts against the same bf16 operand (``mma_cols``). This builds a
copy of the source under build/flash_split_probe/ (the package's own source
is not touched) in which ``mma_cols`` multiplies the hi part only: p and ds
rounded to bf16 once. In one process, in turns (split, one, one, split; N
rounds), it times the bf16 forward and backward of both copies at
``chip_smoke.py``'s four K8 sites: device ms per launch (torch.profiler),
the backward also by kernel (dQ, dK/dV). It prints each copy's largest
error against the plain version relative to max |plain| (o, lse, dq, dk,
dv), the medians over rounds and the card. The one-part copy is the
design the port left because it fails a GPU test (an EncSALayer weight
gradient under bf16 autocast): its numbers say what the split costs, not
that the copy would do. Needs nvcc (``ops._cuda`` finds it) and no network.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "diff_vits_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_split_probe"
ANCHOR = "for (int part = 0; part < 2; ++part)"


def build_one_part(cuda) -> ctypes.CDLL:
    """The copy of flash_attention.cu with one part a product, loaded."""
    s = (SRC / "flash_attention.cu").read_text()
    if s.count(ANCHOR) != 2:
        raise SystemExit("flash_attention.cu changed: expected the two part "
                         f"loops of mma_cols ({ANCHOR!r})")
    OUT.mkdir(parents=True, exist_ok=True)
    for h in SRC.glob("*.cuh"):
        (OUT / h.name).write_text(h.read_text())
    src = OUT / "flash_attention.cu"
    src.write_text(s.replace(ANCHOR, ANCHOR.replace("< 2", "< 1")))
    so = OUT / "flash_attention_one_part.so"
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in cuda._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib


def errors(torch, cs, FA, q, k, v, keep, do, scale):
    """Largest |kernel - plain| / max |plain| of o, lse and dq/dk/dv."""
    o, lse = FA.flash_attention_forward(q, k, v, keep, scale)
    grads = FA.flash_attention_backward(q, k, v, o, lse, do, keep, scale)
    ref_o, ref_lse = FA.sdpa_plain(q, k, v, keep, sm_scale=scale,
                                   with_lse=True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(FA.sdpa_plain(*leaves, keep, sm_scale=scale),
                              leaves, do)
    out = {"o": cs._rel_err(o, ref_o)[1], "lse": cs._rel_err(lse, ref_lse)[1]}
    for n, g, r in zip("qkv", grads, ref):
        out[f"d{n}"] = cs._rel_err(g, r)[1]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, help="also write the numbers as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_split_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from diff_vits_tpu_torch.ops import _cuda
    from diff_vits_tpu_torch.ops import flash_attention as FA
    _cuda.build()
    libs = {"split": _cuda._libs["flash_attention.cu"],
            "one_part": build_one_part(_cuda)}
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = []
    for site, t, s, d, ragged in cs.FLASH_SITES:
        q, k, v, keep = cs._flash_inputs(torch, gen, dev, t, s, d, ragged,
                                         torch.bfloat16)
        do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
        cases.append((site, q, k, v, keep, do, d ** -0.5))
    res = {name: {site: {"errors": None, "fwd": [], "bwd": [], "dq": [],
                         "dkdv": []} for site, *_ in cases} for name in libs}
    for name, lib in libs.items():
        _cuda._libs["flash_attention.cu"] = lib
        for site, q, k, v, keep, do, scale in cases:
            res[name][site]["errors"] = errors(torch, cs, FA, q, k, v, keep,
                                               do, scale)
    for _ in range(args.rounds):
        for name in ("split", "one_part", "one_part", "split"):
            _cuda._libs["flash_attention.cu"] = libs[name]
            for site, q, k, v, keep, do, scale in cases:
                o, lse = FA.flash_attention_forward(q, k, v, keep, scale)
                r = res[name][site]
                fwd, _ = cs.device_times(
                    lambda: FA.flash_attention_forward(q, k, v, keep, scale),
                    iters=20)
                bwd, names = cs.device_times(
                    lambda: FA.flash_attention_backward(q, k, v, o, lse, do,
                                                        keep, scale),
                    iters=20)
                r["fwd"].append(fwd)
                r["bwd"].append(bwd)
                r["dq"].append(sum(ms for n, ms in names.items()
                                   if "flash_bwd_dq" in n))
                r["dkdv"].append(sum(ms for n, ms in names.items()
                                     if "flash_bwd_dkdv" in n))
    _cuda._libs["flash_attention.cu"] = libs["split"]
    for site, *_ in cases:
        for name in libs:
            r = res[name][site]
            med = {k: statistics.median(r[k])
                   for k in ("fwd", "bwd", "dq", "dkdv")}
            r["median"] = med
            print(f"{site:18s} {name:8s} device ms: forward {med['fwd']:.5f} "
                  f"backward {med['bwd']:.5f} (dQ {med['dq']:.5f}, dK/dV "
                  f"{med['dkdv']:.5f}); errors vs plain "
                  + " ".join(f"{k}={e:.2e}" for k, e in r["errors"].items()),
                  flush=True)
        a, b = res["split"][site]["median"], res["one_part"][site]["median"]
        print(f"{site:18s} split / one part: forward {a['fwd'] / b['fwd']:.3f}"
              f" backward {a['bwd'] / b['bwd']:.3f}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, rounds=args.rounds,
                                            sites=res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
