"""Relative-position multi-head self-attention (VITS): kernel K5.

Replaces the Pallas kernel ``fused_rel_self_attention`` of
``diff_vits_tpu/ops/rel_attention.py:90`` (``_kernel`` :40, pallas_call
:118): the whole rel-pos MHA step of the VITS encoder with a head-shared
window of 2w+1 relative keys and values:

    q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
    scores  = (q / sqrt(d)) . k + band of (q / sqrt(d)) . emb_rel_k
    scores  = -1e4 where the query or the key is masked (replaces)
    out     = (softmax(scores) . v + band of probabilities . emb_rel_v) Wo + bo

The JAX kernel takes a [B, T, T] mask; the VITS encoder's mask is always
the outer product of one length mask (``diff_vits_tpu/nn/layers.py:465``),
so the port takes per-item ``lengths`` [B] (None: no mask).

On a CPU tensor the plain PyTorch version below runs: the banded form of
the port's ``MultiHeadAttention`` (the [T, 2w+1] band of relative logits
placed on the score diagonals and read back off the probabilities), with
the operands rounded to the compute dtype where the JAX kernel casts them.
It is also the module's training route (autograd, dropout). On a CUDA
tensor the kernels run, or the call raises, on the route
``_cuda.rel_attention_plan`` gives:

  * both: one ``csrc/gemm.cu`` launch for the q, k and v projections
    (three problems sharing x, float32 outputs), then the core of
    ``csrc/rel_attention.cu``, then ``csrc/gemm.cu`` for the output
    projection;
  * bfloat16 (serving): ``round_kv_kernel`` rounds k and v to bf16 once
    (the reference's cast; it beat a second projection launch writing
    them in bf16, PERF.md), and ``rel_attention_mma_kernel`` (tensor
    cores, key splits over a cluster) reads them by cp.async, rounds
    scale * q itself and writes o in bf16;
  * float32 (the parity route): ``rel_attention_kernel`` (FMA).

Besides ``launches``, the wrapper counts its launches by route in
``mma_launches`` and ``fma_launches`` (:func:`route_counts`). K5 has no
backward, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops.fused_resnet import (
    _check, _check_vecs, _check_weight, mm)

HEAD_DIMS = _cuda.REL_HEAD_DIMS


def band_embeddings(emb: torch.Tensor, length: int, window: int):
    """The nonzero centre [g, 2w'+1, d] of the relative-position table,
    w' = min(window, length - 1) (layers.py:232-246)."""
    w_eff = min(window, length - 1)
    start = window - w_eff
    return emb[:, start:start + 2 * w_eff + 1]


def band_to_abs(band: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2w+1] band logits -> [B, H, L, L], where band[..., t, j]
    lands at key s = t + j - w and every other entry is zero."""
    l, width = band.shape[-2], band.shape[-1]
    w = (width - 1) // 2
    out = band.new_zeros(band.shape[:-1] + (l,))
    for j in range(width):
        off = j - w
        t = torch.arange(max(0, -off), min(l, l - off), device=band.device)
        out[..., t, t + off] = band[..., t, j]
    return out


def abs_to_band(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, L, L] -> [B, H, L, 2w+1] with band[..., t, j] = x[..., t,
    t + j - w] (zero where that key is outside the sequence)."""
    l = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (2 * w + 1,))
    for j in range(2 * w + 1):
        off = j - w
        t = torch.arange(max(0, -off), min(l, l - off), device=x.device)
        out[..., t, j] = x[..., t, t + off]
    return out


def fused_rel_self_attention_plain(
        x, lengths, wq, bq, wk, bk, wv, bv, wo, bo, emb_rel_k, emb_rel_v, *,
        heads: int, window: int, compute_dtype=torch.float32,
        p_drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Plain PyTorch version of K5 (differentiable). ``p_drop`` (training
    only) is applied to the attention probabilities."""
    cdt = compute_dtype
    b, t, c = x.shape
    d = c // heads

    def heads_of(a):
        return a.reshape(b, t, heads, d).transpose(1, 2).to(cdt).float()

    qh = heads_of((mm(x, wq, cdt) + bq.float()) * d ** -0.5)
    kh = heads_of(mm(x, wk, cdt) + bk.float())
    vh = heads_of(mm(x, wv, cdt) + bv.float())
    scores = torch.matmul(qh, kh.transpose(-1, -2))
    key_band = band_embeddings(emb_rel_k, t, window).to(cdt).float()
    scores = scores + band_to_abs(
        torch.einsum("bhtd,gmd->bhtm", qh, key_band))
    if lengths is not None:
        keep = (torch.arange(t, device=x.device)[None]
                < lengths.to(x.device)[:, None])
        mask = keep[:, None, :, None] & keep[:, None, None, :]
        scores = scores.masked_fill(~mask, -1e4)
    p = torch.softmax(scores, dim=-1)
    if p_drop is not None:
        p = p_drop(p)
    out = torch.matmul(p.to(cdt).float(), vh)
    value_band = band_embeddings(emb_rel_v, t, window).float()
    out = out + torch.einsum("bhtm,gmd->bhtd",
                             abs_to_band(p, min(window, t - 1)), value_band)
    out = out.transpose(1, 2).reshape(b, t, c)
    return (mm(out, wo, cdt) + bo.float()).to(x.dtype)


def fused_rel_self_attention(x, lengths, wq, bq, wk, bk, wv, bv, wo, bo,
                             emb_rel_k, emb_rel_v, *, heads: int, window: int,
                             compute_dtype=torch.bfloat16):
    """Rel-pos MHA, K5. x: [B, T, C]; lengths: [B] integer or None;
    wq/wk/wv: [C, C], wo: [C, Co] (``linear.weight.t()`` of an
    ``nn.Linear``, any strides); biases [C] / [Co]; emb_rel_k/v:
    [1, 2w+1, C / heads]. Returns [B, T, Co] in x's dtype.

    CUDA route: x float32 or bfloat16, contiguous; weights in
    ``compute_dtype``, wq/wk/wv with one set of strides; biases float32 or
    ``compute_dtype``, one dtype for bq/bk/bv; tables float32 or
    ``compute_dtype``; head dim in HEAD_DIMS; 2w+1 <= 31 (what
    ``_cuda.rel_attention_plan`` refuses raises ValueError or TypeError)."""
    kw = dict(heads=heads, window=window, compute_dtype=compute_dtype)
    args = (x, lengths, wq, bq, wk, bk, wv, bv, wo, bo, emb_rel_k, emb_rel_v)
    if x.device.type == "cpu":
        return fused_rel_self_attention_plain(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rel_self_attention runs on cpu or cuda, "
                         f"not {x.device}")
    return _kernels(*args, **kw)


def _kernels(x, lengths, wq, bq, wk, bk, wv, bv, wo, bo, emb_rel_k,
             emb_rel_v, *, heads, window, compute_dtype):
    """The kernel route: check every input, then launch."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    b, t, c = x.shape
    dev, cdt, f32 = x.device, compute_dtype, torch.float32
    _check(x, "x", (b, t, c), x.dtype, dev)
    _cuda.dtype_flag(x)
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError("compute_dtype must be float32 or bfloat16")
    if c % heads or c // heads not in HEAD_DIMS:
        raise ValueError(f"rel-attention kernel takes head dims {HEAD_DIMS}; "
                         f"got C={c} over {heads} heads")
    d, co = c // heads, wo.shape[-1]
    if not 0 <= window <= _cuda.REL_MAX_WINDOW:
        raise ValueError(f"rel-attention kernel takes windows 0-15, got "
                         f"{window}")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv)):
        _check_weight(w, name, (c, c), cdt, dev)
    _check_weight(wo, "wo", (c, co), cdt, dev)
    if len({w.stride() for w in (wq, wk, wv)}) > 1:
        raise ValueError("wq, wk and wv must share their strides")
    _check_vecs([("bq", bq), ("bk", bk), ("bv", bv)], c, cdt, dev)
    _check_vecs([("bo", bo)], co, cdt, dev)
    shape = (1, 2 * window + 1, d)
    _check(emb_rel_k, "emb_rel_k", shape, (f32, cdt), dev)
    _check(emb_rel_v, "emb_rel_v", shape, (emb_rel_k.dtype,), dev)
    lens = None
    if lengths is not None:
        if tuple(lengths.shape) != (b,) or lengths.device != dev:
            raise ValueError(f"lengths must be [{b}] on {dev}, got "
                             f"{tuple(lengths.shape)} on {lengths.device}")
        lens = lengths.to(torch.int32).contiguous()

    plan = _cuda.rel_attention_plan(b, t, heads, d, cdt)
    m = b * t
    q, k, v = (torch.empty((b, t, c), device=dev, dtype=f32)
               for _ in range(3))
    _cuda.gemm(x, [wq, wk, wv], [q, k, v], [bq, bk, bv], M=m, N=c, T=t, Ci=c)
    common = (_cuda.ptr(lens), emb_rel_k.data_ptr(), emb_rel_v.data_ptr(),
              _cuda.dtype_flag(emb_rel_k))
    what = f"rel-attention kernel at B={b}, T={t}, H={heads}, d={d}"
    stream = _cuda.stream_ptr(x)
    # the kernels refuse (ValueError) what the plan refuses and misaligned
    # pointers; a failed launch raises RuntimeError
    if plan.tensor_cores:
        k16, v16 = (torch.empty_like(z, dtype=cdt) for z in (k, v))
        _cuda.check(_cuda.fn("rel_attention.cu", "dvt_round_kv")(
            k.data_ptr(), v.data_ptr(), k16.data_ptr(), v16.data_ptr(),
            m * c, stream), what)
        o = torch.empty((b, t, c), device=dev, dtype=cdt)
        _cuda.check(_cuda.fn("rel_attention.cu", "dvt_rel_attention_mma")(
            q.data_ptr(), k16.data_ptr(), v16.data_ptr(), *common,
            o.data_ptr(), b, t, heads, d, window, d ** -0.5, plan.rows,
            plan.splits, stream), what)
        fused_rel_self_attention.mma_launches += 1
    else:
        o = torch.empty((b, t, c), device=dev, dtype=f32)
        _cuda.check(_cuda.fn("rel_attention.cu", "dvt_rel_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *common, o.data_ptr(),
            b, t, heads, d, window, _cuda.dtype_flag(wq), d ** -0.5,
            stream), what)
        fused_rel_self_attention.fma_launches += 1
    out = torch.empty((b, t, co), device=dev, dtype=x.dtype)
    _cuda.gemm(o, [wo], [out], [bo], M=m, N=co, T=t, Ci=c)
    fused_rel_self_attention.launches += 1
    return out


ROUTE_COUNTERS = ("mma_launches", "fma_launches")


def route_counts():
    """{"fused_rel_self_attention.mma_launches": n, ...}: K5's launches by
    route since the last :func:`reset_route_counts`."""
    return {f"fused_rel_self_attention.{c}": getattr(
        fused_rel_self_attention, c) for c in ROUTE_COUNTERS}


def reset_route_counts() -> None:
    for c in ROUTE_COUNTERS:
        setattr(fused_rel_self_attention, c, 0)


fused_rel_self_attention.launches = 0
reset_route_counts()
