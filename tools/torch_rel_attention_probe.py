#!/usr/bin/env python3
"""Where K5's device time goes, in one or more checkouts of the port, in
turns on one card.

    python3 tools/torch_rel_attention_probe.py [DIR ...] [--rounds N]
        [--out FILE]

For each checkout DIR (default: this one), in turns (DIR1, DIR2, ...,
then the same in reverse, ``--rounds`` times), a child process imports
that checkout's ``diff_vits_tpu_torch``, builds its kernels and times
``ops.rel_attention.fused_rel_self_attention`` in bfloat16 at the
TextEncoder's shapes (B=8 at T=128 and 601 with ragged lengths, T=400
unmasked; B=1 at T=128 and 601): the mean device ms of a call over 20
warmed calls by torch.profiler, split into the attention core (kernels
named ``rel_attention*``), the projection GEMMs (``gemm_*``) and the rest,
and the CUDA-event ms of a call. Where the checkout has
``_cuda.rel_attention_plan`` (the tensor-core core), it also times the
other way to hand the core bf16 k and v: two projection launches (q in
float32; k and v written in bf16 by the GEMM), against the route's one
float32 launch for q, k and v and one rounding pass (``round_kv_kernel``).
The inputs come from chip_smoke.py's ``_rel_args`` of this checkout, the
same in every child. Prints one JSON line per child and a summary; needs
one CUDA card and nvcc.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ((8, 128, True), (8, 601, True), (8, 400, False), (1, 128, False),
         (1, 601, False))


def _alternative(torch, RA, _cuda, args, kw):
    """K5 with q from one float32 projection launch and k, v from a second
    launch that writes them in bf16, then the route's core and output
    projection."""
    x, lengths, wq, bq, wk, bk, wv, bv, wo, bo, ek, ev = args
    b, t, c = x.shape
    heads, window = kw["heads"], kw["window"]
    d = c // heads
    plan = _cuda.rel_attention_plan(b, t, heads, d, torch.bfloat16)
    q = torch.empty((b, t, c), device=x.device)
    k16, v16 = (torch.empty((b, t, c), device=x.device, dtype=torch.bfloat16)
                for _ in range(2))
    _cuda.gemm(x, [wq], [q], [bq], M=b * t, N=c, T=t, Ci=c)
    _cuda.gemm(x, [wk, wv], [k16, v16], [bk, bv], M=b * t, N=c, T=t, Ci=c)
    o = torch.empty((b, t, c), device=x.device, dtype=torch.bfloat16)
    lens = None if lengths is None else lengths.to(torch.int32)
    _cuda.check(_cuda.fn("rel_attention.cu", "dvt_rel_attention_mma")(
        q.data_ptr(), k16.data_ptr(), v16.data_ptr(), _cuda.ptr(lens),
        ek.data_ptr(), ev.data_ptr(), _cuda.dtype_flag(ek), o.data_ptr(),
        b, t, heads, d, window, d ** -0.5, plan.rows, plan.splits,
        _cuda.stream_ptr(x)), "rel attention (alternative)")
    out = torch.empty((b, t, wo.shape[-1]), device=x.device, dtype=x.dtype)
    _cuda.gemm(o, [wo], [out], [bo], M=b * t, N=wo.shape[-1], T=t, Ci=c)
    return out


def child(checkout: Path) -> dict:
    import functools
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    for name in [m for m in sys.modules if m.startswith("diff_vits_tpu_torch")]:
        del sys.modules[name]
    from diff_vits_tpu_torch.ops import _cuda
    from diff_vits_tpu_torch.ops import rel_attention as RA
    assert Path(RA.__file__).resolve().is_relative_to(checkout.resolve())
    _cuda.build()
    dev = torch.device("cuda")
    kw = dict(heads=cs.REL_HEADS, window=cs.REL_WINDOW)
    rows = []
    for b, t, ragged in CASES:
        gen = torch.Generator(device=dev).manual_seed(11)
        args = cs._rel_args(torch, gen, dev, b, t, torch.bfloat16, ragged)
        fn = functools.partial(RA.fused_rel_self_attention, *args,
                               compute_dtype=torch.bfloat16, **kw)
        total, by_name = cs.device_times(fn, iters=20)
        core = sum(ms for k, ms in by_name.items() if "rel_attention" in k)
        gemm = sum(ms for k, ms in by_name.items() if "gemm_" in k)
        row = dict(b=b, t=t, ragged=ragged, device_ms=total, core_ms=core,
                   gemm_ms=gemm, other_ms=total - core - gemm,
                   ms=cs.cuda_time(fn), kernels=sorted(by_name))
        if hasattr(_cuda, "rel_attention_plan"):
            alt = functools.partial(_alternative, torch, RA, _cuda, args, kw)
            ref = fn().float()
            row["alt_max_abs_diff"] = (alt().float() - ref).abs().max().item()
            row["alt_device_ms"] = cs.device_times(alt, iters=20)[0]
        rows.append(row)
    return dict(checkout=str(checkout), card=cs.card_line(), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child is not None:
        print("RESULT " + json.dumps(child(a.child)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_rel_attention_probe: no CUDA device", file=sys.stderr)
        return 1
    order = []
    for _ in range(a.rounds):
        order += list(a.dirs) + list(reversed(a.dirs))
    results = []
    for d in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(d)],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps(res), flush=True)
        results.append(res)
    for res in results:
        print(f"{res['checkout']} ({res['card']}):")
        for r in res["rows"]:
            alt = (f", two projection launches {r['alt_device_ms']:.4f}"
                   if "alt_device_ms" in r else "")
            print(f"  B={r['b']} T={r['t']} {'ragged' if r['ragged'] else ''}"
                  f": device {r['device_ms']:.4f} ms = core "
                  f"{r['core_ms']:.4f} + gemm {r['gemm_ms']:.4f} + other "
                  f"{r['other_ms']:.4f}; events {r['ms']:.4f}{alt}")
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
