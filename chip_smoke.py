#!/usr/bin/env python3
"""Drive the PyTorch port (``diff_vits_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out DIR]

``--out DIR`` also writes the kernel rows and the path phase's numbers as
``DIR/kernels.json`` and ``DIR/path.json``.

Phases, each of which fails the run:

1. card: name and power limit (nvidia-smi);
2. build: nvcc compiles ``diff_vits_tpu_torch/csrc`` into ``build/``;
3. kernels: each of K1-K4 (the four UNet kernels) runs at the main path's
   shapes in float32 and bfloat16 and is held against its plain PyTorch
   version (max |kernel - plain| / max |plain| <= 1e-3 in float32, 3e-2 in
   bfloat16), with its weights in the layout the UNet modules hand over
   (strided views of nn.Linear / nn.Conv1d parameters, vectors in the
   compute dtype); kernel, plain and library-composition times (CUDA
   events, warmed, mean of many back-to-back calls, the wrapper's host work
   included), the kernel route's device time (torch.profiler, summed
   device activity per call) and the roofline bound are printed;
4. path: ``BatchSynthesizer`` (bf16 weights, batch 8, mel buckets 400 and
   800, 30-step UniPC) answers 10 requests at the widths of
   ``configs/reference_parity.json`` with random weights from a seed; every
   kernel counter must rise by exactly 22/16/16/16 per UNet call;
5. parity: one fixed batch in float32 through the kernels and through the
   plain path on the card (same weights, injected initial noise, zero prior
   noise), max |mel difference| <= 5e-3;
6. serving numbers: per-request latency at batch 1 and 8, real-time factor,
   peak device memory; then one more warmed ``synthesize`` at each batch
   under torch.profiler: the device's busy share and device time by
   kernel (informational; in ``path.json`` with ``--out``).

The last line of standard output is one JSON object with the device; the
line before it the kernel table. Exits non-zero, printing no result, when
there is no CUDA device or the port's package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # FP32 FMA / bf16 TC
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
REPLACES = {
    "fused_resnet_block": "diff_vits_tpu/ops/fused_resnet.py:133",
    "fused_self_attention": "diff_vits_tpu/ops/fused_transformer.py:139",
    "fused_cross_attention": "diff_vits_tpu/ops/fused_transformer.py:173",
    "fused_geglu_ff": "diff_vits_tpu/ops/fused_transformer.py:246",
}
SOURCE = {
    "fused_resnet_block": "diff_vits_tpu_torch/csrc/gemm.cu",
    "fused_self_attention": "diff_vits_tpu_torch/csrc/attention.cu",
    "fused_cross_attention": "diff_vits_tpu_torch/csrc/attention.cu",
    "fused_geglu_ff": "diff_vits_tpu_torch/csrc/gemm.cu",
}
# per UNet call (nn/unet1d.py: 22 resnets, 16 transformer blocks)
PER_UNET = {"fused_resnet_block": 22, "fused_self_attention": 16,
            "fused_cross_attention": 16, "fused_geglu_ff": 16}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches, warmed."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, iters: int = 10):
    """Mean device milliseconds per ``fn()``: the summed duration of the
    device activities torch.profiler records over ``iters`` warmed calls.
    None when three windows in a row record no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    return None


# -- kernel phase -----------------------------------------------------------

def _module_layout(torch, t, dtype):
    """``t`` as the UNet modules pass it to the fused ops: a [.., in, out]
    weight as a view of nn.Conv1d [out, in, k] or nn.Linear [out, in]
    storage; a norm parameter or bias in the compute dtype."""
    if t.dim() == 3:
        return t.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    if t.dim() == 2:
        return t.t().contiguous().t()
    return t.to(dtype)


def _kernel_cases(torch, dtype, gen, dev):
    """(kernel name, site, kernel fn, plain fn, library fn, flops, bytes)
    at the main path's shapes: denoiser UNet levels 0/2/3 at B=8 (T 400,
    100, 50; C 128, 384, 512; head dims 16, 48, 64), its widest up-block
    resnet (Ci=1024), and the duration-predictor UNet at T=601 (C=64,
    head dim 8, cross-attention keys of width 256). Cross-attention keys:
    S=267 prompt frames with a ragged mask."""
    import torch.nn.functional as F
    from diff_vits_tpu_torch.ops import fused_resnet as FR
    from diff_vits_tpu_torch.ops import fused_transformer as FT

    f32 = torch.float32
    esz = torch.finfo(dtype).bits // 8

    def r(*shape, scale=1.0, dt=f32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    def act(*shape):
        return r(*shape, dt=dtype)

    def w(*shape, scale):
        """A weight [.., in, out] in the module's layout and dtype."""
        return _module_layout(torch, r(*shape, scale=scale, dt=dtype), dtype)

    def v(n, scale=0.1, one=0.0):
        """A norm parameter or bias in the module's dtype."""
        return _module_layout(torch, one + r(n, scale=scale), dtype)

    cases = []
    b = 8
    for site, t, ci, co, groups in [("denoiser L0", 400, 128, 128, 8),
                                    ("denoiser L2 down", 100, 256, 384, 8),
                                    ("denoiser L3 up", 50, 1024, 512, 8),
                                    ("dp-unet L0", 601, 64, 64, 8)]:
        x = act(b, t, ci)
        args = (x, r(b, 2 * co, scale=0.3), v(ci, one=1.0), v(ci),
                w(3, ci, co, scale=(3 * ci) ** -0.5), v(co), v(co, one=1.0),
                v(co), w(3, co, co, scale=(3 * co) ** -0.5), v(co))
        sc = ((w(ci, co, scale=ci ** -0.5), v(co)) if ci != co
              else (None, None))
        kw = dict(groups=groups, eps=1e-5, compute_dtype=dtype)
        w_conv1 = args[4].permute(2, 1, 0)       # the nn.Conv1d parameter
        w_conv2 = args[8].permute(2, 1, 0)

        def lib(args=args, sc=sc, w1=w_conv1, w2=w_conv2, co=co, g=groups):
            x, film = args[0], args[1]
            h = F.silu(F.group_norm(x.transpose(1, 2), g, args[2].to(x.dtype),
                                    args[3].to(x.dtype), 1e-5))
            h = F.conv1d(h, w1, args[5].to(x.dtype), padding=1)
            h = F.group_norm(h, g, args[6].to(x.dtype), args[7].to(x.dtype),
                             1e-5)
            fl = film.to(x.dtype)[:, :, None]
            h = F.silu(h * (1 + fl[:, :co]) + fl[:, co:])
            h = F.conv1d(h, w2, args[9].to(x.dtype), padding=1)
            s = (x if sc[0] is None else
                 F.linear(x, sc[0].t(), sc[1].to(x.dtype)))
            return s + h.transpose(1, 2)

        m = b * t
        flops = 2 * m * 3 * ci * co + 2 * m * 3 * co * co \
            + (2 * m * ci * co if sc[0] is not None else 0)
        nbytes = esz * (m * ci + m * co + 3 * ci * co + 3 * co * co
                        + (ci * co if sc[0] is not None else 0)) \
            + 4 * b * 2 * co + esz * (2 * ci + 6 * co)
        cases.append(("fused_resnet_block", f"{site} B={b} T={t} Ci={ci} "
                      f"Co={co}",
                      lambda a=args, s=sc, k=kw: FR.fused_resnet_block(
                          *a, *s, **k),
                      lambda a=args, s=sc, k=kw: FR.fused_resnet_block_plain(
                          *a, *s, **k), lib, flops, nbytes))

    for site, t, c, ck in [("denoiser L0", 400, 128, 128),
                           ("denoiser L2", 100, 384, 128),
                           ("denoiser mid", 50, 512, 128),
                           ("dp-unet L0", 601, 64, 256)]:
        heads, s = 8, 267
        x = act(b, t, c)
        ln = (v(c, one=1.0), v(c))
        wq, wo, wk, wv = (w(c, c, scale=c ** -0.5) for _ in range(4))
        bo = v(c)
        m = b * t
        sargs = (x, *ln, wq, wk, wv, wo, bo)

        def lib_self(a=sargs, heads=heads):
            x, s1, b1, wq, wk, wv, wo, bo = a
            h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype),
                             b1.to(x.dtype), 1e-5)

            def sp(z):
                return z.unflatten(-1, (heads, -1)).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                sp(h @ wq), sp(h @ wk), sp(h @ wv))
            return x + o.transpose(1, 2).flatten(2) @ wo + bo.to(x.dtype)

        cases.append(("fused_self_attention",
                      f"{site} B={b} T={t} C={c} d={c // heads}",
                      lambda a=sargs, h=heads: FT.fused_self_attention(
                          *a, heads=h, compute_dtype=dtype),
                      lambda a=sargs, h=heads: FT.fused_self_attention_plain(
                          *a, heads=h, compute_dtype=dtype), lib_self,
                      2 * m * c * 3 * c + 4 * b * t * t * c + 2 * m * c * c,
                      esz * (2 * m * c + 4 * c * c + 3 * c)))

        ctx = act(b, s, ck)
        keep = torch.ones(b, s, device=dev)
        for i in range(b):
            keep[i, s - 29 * i:] = 0.0
        bias = ((1 - keep) * -10000.0)[:, None, :].contiguous()
        wk2, wv2 = (w(ck, c, scale=ck ** -0.5) for _ in range(2))
        cargs = (x, ctx, bias, *ln, wq, wk2, wv2, wo, bo)

        def lib_cross(a=cargs, heads=heads):
            x, ctx, bias, s1, b1, wq, wk, wv, wo, bo = a
            h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype),
                             b1.to(x.dtype), 1e-5)

            def sp(z):
                return z.unflatten(-1, (heads, -1)).transpose(1, 2)
            o = F.scaled_dot_product_attention(
                sp(h @ wq), sp(ctx @ wk), sp(ctx @ wv),
                attn_mask=bias[:, None].to(x.dtype))
            return x + o.transpose(1, 2).flatten(2) @ wo + bo.to(x.dtype)

        cases.append(("fused_cross_attention",
                      f"{site} B={b} T={t} C={c} d={c // heads} S={s} "
                      f"Ck={ck}",
                      lambda a=cargs, h=heads: FT.fused_cross_attention(
                          *a, heads=h, compute_dtype=dtype),
                      lambda a=cargs, h=heads: FT.fused_cross_attention_plain(
                          *a, heads=h, compute_dtype=dtype), lib_cross,
                      2 * m * c * c + 4 * b * s * ck * c + 4 * b * t * s * c
                      + 2 * m * c * c,
                      esz * (2 * m * c + b * s * ck + 2 * c * c + 2 * ck * c
                             + 3 * c) + 4 * b * s))

        fargs = (x, *ln, w(c, 8 * c, scale=c ** -0.5), v(8 * c),
                 w(4 * c, c, scale=(4 * c) ** -0.5), bo)

        def lib_ff(a=fargs):
            x, s1, b1, w1, bb1, w2, bb2 = a
            h = F.layer_norm(x, (x.shape[-1],), s1.to(x.dtype),
                             b1.to(x.dtype), 1e-5)
            v, g = (h @ w1 + bb1.to(x.dtype)).chunk(2, dim=-1)
            return x + (v * F.gelu(g)) @ w2 + bb2.to(x.dtype)

        cases.append(("fused_geglu_ff", f"{site} B={b} T={t} C={c}",
                      lambda a=fargs: FT.fused_geglu_ff(
                          *a, compute_dtype=dtype),
                      lambda a=fargs: FT.fused_geglu_ff_plain(
                          *a, compute_dtype=dtype), lib_ff,
                      2 * m * c * 8 * c + 2 * m * 4 * c * c,
                      esz * (2 * m * c + 12 * c * c + 11 * c)))
    return cases


def kernel_phase(torch, dev, headline_dtype="bfloat16"):
    """Hold every kernel against its plain version at every case; returns
    (ok, rows, per kernel: the first row in ``headline_dtype``, the main
    path's, with the largest |kernel - plain| of all its rows)."""
    ok = True
    rows, summary = [], {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(1234)
        for name, site, kfn, pfn, lfn, flops, nbytes in _kernel_cases(
                torch, dtype, gen, dev):
            out = kfn()
            torch.cuda.synchronize()
            ref = pfn()
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-30)
            finite = bool(torch.isfinite(out.float()).all())
            good = finite and rel <= TOL[dname]
            ok &= good
            ms = cuda_time(kfn)
            device_ms = device_time(kfn)
            plain_ms = cuda_time(pfn, iters=5)
            lib_ms = cuda_time(lfn)
            bound_ms = 1e3 * max(nbytes / PEAK_BYTES_S,
                                 flops / PEAK_FLOPS[dname])
            bound_by = ("bytes" if nbytes / PEAK_BYTES_S
                        >= flops / PEAK_FLOPS[dname] else "operations")
            row = dict(name=name, site=site, dtype=dname,
                       max_abs_err=diff, rel_err=rel, ok=good, ms=ms,
                       device_ms=device_ms, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                       bytes=nbytes)
            rows.append(row)
            log(f"kernel {name:22s} {dname:8s} {site:44s} "
                f"rel_err={rel:.2e} {'ok' if good else 'FAIL'} "
                f"ms={ms:.4f} device_ms={device_ms} "
                f"plain_ms={plain_ms:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by})")
            if dname == headline_dtype and name not in summary:
                summary[name] = dict(row)
    for name, row in summary.items():
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows
                                 if r["name"] == name)
    return ok, rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for kernels.json and path.json")
    out_dir = ap.parse_args(argv).out
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "diff_vits_tpu_torch").is_dir():
        print("chip_smoke: diff_vits_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from diff_vits_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} ({torch.cuda.device_count()} visible); "
        f"nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_log = _cuda.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build_log)

    phases = {}
    k_ok, rows, summary = kernel_phase(torch, dev)
    phases["kernels"] = k_ok

    p_ok, counts, details = path_phase(torch, dev, card)
    phases.update(p_ok)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "kernels.json").write_text(json.dumps(
            dict(card=card, rows=rows), indent=1))
        (out_dir / "path.json").write_text(json.dumps(details, indent=1))

    table = {"kernels": [dict(
        name=name, route="cuda", source=SOURCE[name],
        replaces=REPLACES[name], launches=counts.get(name, 0),
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"])
        for name, row in summary.items()]}
    log(f"phases: {phases}")
    if not all(phases.values()):
        log("chip_smoke: FAILED")
        return 1
    log(f"card: {card}")
    log(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _requests(torch, gen, symbols_n, refer_frames):
    """10 tokenised requests: 6 texts of 70-128 phones (text bucket 128)
    and 4 of 300-600 (bucket 601); random prompt mels [267, 100]."""
    reqs = []
    for i, n in enumerate([70, 96, 128, 81, 110, 77, 300, 452, 600, 377]):
        def ids(hi):
            return torch.randint(0, hi, (n,), generator=gen).numpy()
        reqs.append((f"utt{i:02d}", ids(symbols_n - 1) + 1, ids(11), ids(3),
                     torch.randn(refer_frames, 100, generator=gen).numpy()))
    return reqs


def _count_unet_calls(model):
    """Forward pre-hooks counting denoising UNet calls (embedding-only
    requests launch no kernel and are not counted)."""
    from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
    calls = [0]

    def hook(module, args, kwargs):
        if kwargs.get("embedding_request") is None:
            calls[0] += 1
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules()
               if isinstance(m, UNet1DConditionModel)]
    return calls, handles


def path_phase(torch, dev, card):
    """Serving run through the kernels, the fp32 kernels-vs-plain parity
    run, and the serving numbers. Returns ({phase: ok}, launch counts,
    the numbers as a JSON-ready dict)."""
    import numpy as np
    from diff_vits_tpu_torch import ops
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.utils.init import init_random

    ok = {}
    cfg = load_config(str(ROOT / "configs" / "reference_parity.json"))
    model = DiffVits(cfg, len(symbols), device=dev)
    init_random(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"path: reference_parity widths, {n_params} parameters, random "
        "weights (seed 0)")

    # -- serving: BatchSynthesizer, bf16, batch 8, mel buckets 400/800 ----
    syn = BatchSynthesizer(cfg, model.state_dict(), batch_size=8,
                           mel_buckets=(400, 800), dtype=torch.bfloat16,
                           device=dev)
    reqs = _requests(torch, torch.Generator().manual_seed(1), len(symbols),
                     syn.refer_frames)
    calls, handles = _count_unet_calls(syn.model)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = syn.synthesize_all(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for h in handles:
        h.remove()
    want = {name: n * calls[0] for name, n in PER_UNET.items()}
    order_ok = [r[0] for r in results] == [r[0] for r in reqs]
    finite = all(np.isfinite(m).all() and m.ndim == 2 and m.shape[1] == 100
                 and m.shape[0] >= 1 for _, m in results)
    ok["serve"] = order_ok and finite and counts == want
    log(f"serve: {len(results)} requests in {wall:.3f} s (first call of "
        f"each bucket shape included); frames "
        f"{[m.shape[0] for _, m in results]}; UNet calls {calls[0]}; "
        f"launches {counts} (want {want}); order {order_ok}; finite "
        f"{finite}")

    # -- parity: one fp32 batch, kernels vs the plain path on the card ----
    gen = torch.Generator().manual_seed(2)
    syn.batch_size = 2
    batch = syn.pad_batch(reqs[:2], 128)
    noise = torch.randn(2, 400, 100, generator=gen).to(dev)
    out = {}
    for route in (True, False):
        set_use_fused(model, route)
        out[route] = synthesize(model, *batch, noise_scale=0.0, max_len=400,
                                init_noise=noise, device=dev)
    set_use_fused(model, True)
    (mel_k, len_k), (mel_p, len_p) = out[True], out[False]
    err = (mel_k - mel_p).abs().max().item()
    ok["parity_fp32"] = (bool(torch.equal(len_k, len_p)) and err <= 5e-3
                         and bool(torch.isfinite(mel_k).all()))
    log(f"parity fp32 (kernels vs plain, 2 utterances, 400 frames, 30 "
        f"steps): frames {len_k.tolist()} vs {len_p.tolist()}, max |diff| "
        f"{err:.3e} (gate 5e-3), max |mel| {mel_p.abs().max().item():.3f}")
    del model

    # -- serving numbers: latency and real-time factor at batch 1 and 8 --
    numbers = {}
    audio_s = 400 * cfg.data.hop_length / cfg.data.sampling_rate
    short = [r for r in reqs if len(r[1]) <= 128]
    torch.cuda.reset_peak_memory_stats()
    for b in (1, 8):
        syn.batch_size = b
        args = syn.pad_batch([short[i % len(short)] for i in range(b)], 128)
        gen = torch.Generator().manual_seed(3)
        runs = []
        for _ in range(4):      # first run warms the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synthesize(syn.model, *args, generator=gen, max_len=400,
                       device=dev)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        lat = sorted(runs[1:])[1]
        numbers[f"b{b}"] = dict(latency_s=lat, runs_s=runs,
                                rtf=b * audio_s / lat)
        log(f"serving b={b}: latency {lat * 1e3:.1f} ms per request "
            f"(median of {runs[1:]}), real-time factor "
            f"{b * audio_s / lat:.1f}x ({b} x {audio_s:.2f} s of audio); "
            f"card {card}")
    numbers["max_memory_allocated_GB"] = \
        torch.cuda.max_memory_allocated() / 1e9
    log(f"peak device memory {numbers['max_memory_allocated_GB']:.2f} GB; "
        f"card {card}")
    numbers["profile"] = {f"b{b}": profile_synthesize(
        torch, syn, [short[i % len(short)] for i in range(b)], card)
        for b in (1, 8)}
    return ok, counts, dict(card=card, serve_wall_s=wall,
                            unet_calls=calls[0], launches=counts,
                            parity_max_abs=err, numbers=numbers)


def profile_synthesize(torch, syn, requests, card):
    """One warmed ``synthesize`` of ``requests`` (text bucket 128, mel
    bucket 400) under torch.profiler: wall time, the device's busy share
    (summed device activity over wall time; one stream, so nothing
    overlaps), device time by kernel name, and kernels launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from diff_vits_tpu_torch.models.diff_vits import synthesize

    syn.batch_size = len(requests)
    args = syn.pad_batch(requests, 128)
    gen = torch.Generator().manual_seed(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synthesize(syn.model, *args, generator=gen, max_len=400,
                   device=syn.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    ours = {k: v for k, v in by_name.items() if "dvt::" in k}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    res = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / wall_us,
               device_launches=sum(n for n, _ in by_name.values()),
               port_kernels_ms=sum(us for _, us in ours.values()) / 1e3,
               port_kernel_launches=sum(n for n, _ in ours.values()),
               top=[dict(name=k[:90], launches=n, ms=us / 1e3)
                    for k, (n, us) in top])
    log(f"profile b={len(requests)}: wall {res['wall_ms']:.1f} ms, device "
        f"busy {res['device_busy_ms']:.1f} ms "
        f"({100 * res['device_busy_share']:.1f}%), "
        f"{res['device_launches']} device activities, of which the port's "
        f"kernels {res['port_kernel_launches']} taking "
        f"{res['port_kernels_ms']:.1f} ms; card {card}")
    for row in res["top"]:
        log(f"  {row['ms']:9.2f} ms {row['launches']:6d}x {row['name']}")
    return res


if __name__ == "__main__":
    sys.exit(main())
