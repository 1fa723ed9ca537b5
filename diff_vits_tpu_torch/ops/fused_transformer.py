"""Fused UNet transformer sub-blocks: kernels K2, K3 and K4.

Replace the Pallas kernels of ``diff_vits_tpu/ops/fused_transformer.py``:

  K2 ``fused_self_attention`` (:139; ``_attn_kernel_self`` :70, call :151)
      x + Wo . SDPA(LN(x)) + bo, no mask;
  K3 ``fused_cross_attention`` (:173; ``_attn_kernel_cross`` :79, call :190)
      x + Wo . SDPA(q = LN(x), kv = ctx, additive 0/-10000 key bias) + bo;
  K4 ``fused_geglu_ff`` (:246; ``_ff_kernel`` :232, call :257)
      x + W2 . (val * gelu(gate)) + b2 with [val, gate] = W1 . LN(x) + b1.

On a CPU tensor each runs its plain PyTorch version below (the math of the
JAX package's XLA twins, :99-127 and :282-296; GELU with the exact erf
where Pallas used the A&S 7.1.26 rational form). On a CUDA tensor the
hand-written kernels of ``diff_vits_tpu_torch/csrc`` run, or the call
raises; their gradient is that of the plain version, recomputed
(``ops/kernel_function.py``, JAX's ``defvjp`` through the twin):

  K2: norm_stats(rows) -> gemm(LN prologue; q, k, v as three problems of
      one launch) -> attention -> gemm(Wo + bo + residual)
  K3: norm_stats(rows) -> gemm(LN; q) -> gemm(ctx; k, v) -> attention(key
      bias) -> gemm(Wo + bo + residual)
  (attention: ``_cuda.attention``, planned by ``_cuda.attention_plan``;
  its plain version is :func:`attention_plain`)
  K4: norm_stats(rows) -> gemm(LN; W1 with the GEGLU pair epilogue) ->
      gemm(W2 + b2 + residual)

A Pallas program holds the whole [T, C] tile and its [T, 8C] feed-forward
intermediate in VMEM. On the H100 the LayerNorm output is recomputed in
each GEMM's tile loads and never written; the attention scores live only
in registers (online softmax); the GEGLU gate and value halves meet in one
tile's registers, so only the [T, 4C] product reaches memory, in the
compute dtype where the reference casts it. q, k, v and the attention
output do reach memory. On the H100 the projections and the feed-forward
products run on tensor cores (bf16, csrc/gemm.cu), their K split over a
thread-block cluster until the grid fills the 132 SMs: at these shapes
(M = B*T of 50-6,400 rows) the grid and each block's K-step latency, not
the work, bound them.
The attention core (csrc/attention.cu) runs QK^T and PV on tensor cores
in bf16, 16 queries a warp, its keys split over a cluster where the grid
is small; float32 (the parity route) keeps exact FMA products.

Under sequence parallelism (``seq=``, a ``parallel.activations.SeqLevel``)
K2's core is the ring of ``parallel.ring_attention`` over the ``seq``
ranks (K8 blocks on the card, ``sdpa_plain`` ones on the CPU) in place of
the attention core; its LayerNorm, projections, Wo and residual stay per
frame. K3 and K4 need nothing: their queries and rows are this rank's
frames and the context is whole.
"""
from __future__ import annotations

import functools

import torch

from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops.fused_resnet import (
    _check, _check_vecs, _check_weight, mm)
from diff_vits_tpu_torch.ops.kernel_function import run_kernels


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def attention_plain(q, k, v, bias, heads: int, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the attention core of K2 and K3
    (csrc/attention.cu; the score/softmax/PV part of the JAX package's
    ``_mha`` and ``_xla_mha``): per head, softmax(d**-0.5 q.k^T + bias) v
    on q [B, T, H*d] and k, v [B, S, H*d], with q, k, v and the
    probabilities rounded to ``compute_dtype`` before their products, the
    sums in float32. ``bias``: additive, [B, S] or [B, 1, S], or None.
    Returns float32 [B, T, H*d]."""
    b, t, inner = q.shape
    d = inner // heads

    def split(a):
        return a.reshape(b, -1, heads, d).transpose(1, 2).to(
            compute_dtype).float()

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * d ** -0.5
    if bias is not None:
        s = s + bias.float().reshape(b, 1, 1, -1)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(compute_dtype).float(), split(v))
    return o.transpose(1, 2).reshape(b, t, inner)


def _mha(h_q, src, wq, wk, wv, wo, bo, bias, heads: int, cdt):
    q, k, v = mm(h_q, wq, cdt), mm(src, wk, cdt), mm(src, wv, cdt)
    o = attention_plain(q, k, v, bias, heads, cdt)
    return mm(o, wo, cdt) + bo.float()


def _heads(a, heads: int):
    """[B, T, H*d] -> a [B, H, T, d] view."""
    b, t, c = a.shape
    return a.view(b, t, heads, c // heads).transpose(1, 2)


def _ring(q, k, v, heads: int, seq):
    """The ring core on [B, T, H*d] q, k, v: [B, T, H*d] out."""
    from diff_vits_tpu_torch.parallel.ring_attention import ring_attention
    b, t, c = q.shape
    o = ring_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads),
                       None, group=seq.group, sizes=seq.sizes)
    return o.transpose(1, 2).reshape(b, t, c)


def fused_self_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *,
                               heads: int, compute_dtype=torch.bfloat16,
                               seq=None):
    """Plain PyTorch version of K2."""
    xf = x.float()
    h = _layer_norm(xf, ln_scale, ln_bias)
    if seq is None:
        o = _mha(h, h, wq, wk, wv, wo, bo, None, heads, compute_dtype)
    else:
        cdt = compute_dtype
        q, k, v = (mm(h, w, cdt).to(cdt).float() for w in (wq, wk, wv))
        o = mm(_ring(q, k, v, heads, seq), wo, cdt) + bo.float()
    return (xf + o).to(x.dtype)


def fused_cross_attention_plain(x, ctx, bias, ln_scale, ln_bias, wq, wk, wv,
                                wo, bo, *, heads: int,
                                compute_dtype=torch.bfloat16):
    """Plain PyTorch version of K3."""
    xf = x.float()
    h = _layer_norm(xf, ln_scale, ln_bias)
    o = _mha(h, ctx.float(), wq, wk, wv, wo, bo, bias, heads, compute_dtype)
    return (xf + o).to(x.dtype)


def fused_geglu_ff_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                         compute_dtype=torch.bfloat16):
    """Plain PyTorch version of K4."""
    cdt = compute_dtype
    xf = x.float()
    h = _layer_norm(xf, ln_scale, ln_bias)
    h1 = mm(h, w1, cdt) + b1.float()
    inner = h1.shape[-1] // 2
    g = h1[..., :inner] * torch.nn.functional.gelu(h1[..., inner:])
    o = mm(g, w2, cdt) + b2.float()
    return (xf + o).to(x.dtype)


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel route (CUDA), False for the plain one (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, T, C], got {tuple(x.shape)}")
    _check(x, "x", tuple(x.shape), x.dtype, x.device)
    _cuda.dtype_flag(x)


def _check_attn(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads, cdt,
                ck: int, same_launch_q: bool) -> None:
    c, dev = x.shape[-1], x.device
    if c % heads or (c // heads) not in _cuda.ATTN_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims 8, 16, 32, 48 "
                         f"or 64; got C={c} over {heads} heads")
    _check_vecs([("ln_scale", ln_scale), ("ln_bias", ln_bias)], c, cdt, dev)
    _check_vecs([("bo", bo)], c, cdt, dev)
    _check_weight(wq, "wq", (c, c), cdt, dev)
    _check_weight(wk, "wk", (ck, c), cdt, dev)
    _check_weight(wv, "wv", (ck, c), cdt, dev)
    _check_weight(wo, "wo", (c, c), cdt, dev)
    # the projections that share one GEMM launch share its strides
    shared = (wq, wk, wv) if same_launch_q else (wk, wv)
    if len({w.stride() for w in shared}) > 1:
        raise ValueError("the q/k/v weights of one launch must share their "
                         "strides")


def fused_self_attention(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *,
                         heads: int, compute_dtype=torch.bfloat16, seq=None):
    """x + AttnOut(SDPA(LN(x))). x: [B, T, C]; wq/wk/wv/wo: [C, C] in
    ``compute_dtype``, any strides (``linear.weight.t()`` of an
    ``nn.Linear``), wq/wk/wv the same ones; ln_*, bo float32 or ``compute_dtype``.
    CUDA route: x and the vectors contiguous. ``seq``: the
    sequence-parallel level x's frames are of (module docstring)."""
    if not _route(x, "fused_self_attention"):
        return fused_self_attention_plain(
            x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads=heads,
            compute_dtype=compute_dtype, seq=seq)
    kw = dict(heads=heads, compute_dtype=compute_dtype, seq=seq)
    return run_kernels(functools.partial(_self_attention_kernels, **kw),
                       functools.partial(fused_self_attention_plain, **kw),
                       x, ln_scale, ln_bias, wq, wk, wv, wo, bo)


def _self_attention_kernels(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *,
                            heads, compute_dtype, seq=None):
    """The kernel route: check every input, then launch."""
    _check_x(x, "fused_self_attention")
    b, t, c = x.shape
    _check_attn(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads,
                compute_dtype, c, True)
    fused_self_attention.launches += 1
    m = b * t
    stats = _cuda.norm_stats(x, m, 1, c, 1, 1e-5)
    q, k, v = (torch.empty((b, t, c), device=x.device, dtype=compute_dtype)
               for _ in range(3))
    _cuda.gemm(x, [wq, wk, wv], [q, k, v], [None] * 3, M=m, N=c, T=t, Ci=c,
               norm=_cuda.LAYER_NORM, stats=stats, norm_w=ln_scale,
               norm_b=ln_bias)
    if seq is None:
        o = _cuda.attention(q, k, v, None, heads)
    else:
        o = _ring(q, k, v, heads, seq)
    out = torch.empty_like(x)
    _cuda.gemm(o, [wo], [out], [bo], M=m, N=c, T=t, Ci=c, res=x)
    return out


fused_self_attention.launches = 0


def fused_cross_attention(x, ctx, bias, ln_scale, ln_bias, wq, wk, wv, wo,
                          bo, *, heads: int, compute_dtype=torch.bfloat16):
    """x + AttnOut(SDPA(q=LN(x), kv=ctx) + bias). x: [B, T, C]; ctx:
    [B, S, Ck] in x's dtype; bias: [B, 1, S] additive (0 / -10000) float32
    or None; wk/wv: [Ck, C]; weights and vectors as for
    ``fused_self_attention``. CUDA route: x, ctx, bias contiguous."""
    if not _route(x, "fused_cross_attention"):
        return fused_cross_attention_plain(
            x, ctx, bias, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads=heads,
            compute_dtype=compute_dtype)
    kw = dict(heads=heads, compute_dtype=compute_dtype)
    return run_kernels(functools.partial(_cross_attention_kernels, **kw),
                       functools.partial(fused_cross_attention_plain, **kw),
                       x, ctx, bias, ln_scale, ln_bias, wq, wk, wv, wo, bo)


def _cross_attention_kernels(x, ctx, bias, ln_scale, ln_bias, wq, wk, wv, wo,
                             bo, *, heads, compute_dtype):
    """The kernel route: check every input, then launch."""
    _check_x(x, "fused_cross_attention")
    b, t, c = x.shape
    if ctx.dim() != 3 or ctx.shape[0] != b:
        raise ValueError(f"ctx must be [B, S, Ck], got {tuple(ctx.shape)}")
    s, ck = ctx.shape[1], ctx.shape[2]
    _check(ctx, "ctx", (b, s, ck), x.dtype, x.device)
    _check_attn(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, heads,
                compute_dtype, ck, False)
    if bias is not None:
        _check(bias, "bias", (b, 1, s), torch.float32, x.device)
    fused_cross_attention.launches += 1
    m = b * t
    stats = _cuda.norm_stats(x, m, 1, c, 1, 1e-5)
    q = torch.empty((b, t, c), device=x.device, dtype=compute_dtype)
    _cuda.gemm(x, [wq], [q], [None], M=m, N=c, T=t, Ci=c,
               norm=_cuda.LAYER_NORM, stats=stats, norm_w=ln_scale,
               norm_b=ln_bias)
    k, v = (torch.empty((b, s, c), device=x.device, dtype=compute_dtype)
            for _ in range(2))
    _cuda.gemm(ctx, [wk, wv], [k, v], [None] * 2, M=b * s, N=c, T=s, Ci=ck)
    o = _cuda.attention(q, k, v, None if bias is None else bias.view(b, s),
                        heads)
    out = torch.empty_like(x)
    _cuda.gemm(o, [wo], [out], [bo], M=m, N=c, T=t, Ci=c, res=x)
    return out


fused_cross_attention.launches = 0


def fused_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                   compute_dtype=torch.bfloat16):
    """x + W2(GEGLU(W1(LN(x)))). x: [B, T, C]; w1: [C, 8C]; w2: [4C, C] in
    ``compute_dtype``, any strides; ln_*, b1, b2 float32 or
    ``compute_dtype``. CUDA route: x and the vectors contiguous."""
    if not _route(x, "fused_geglu_ff"):
        return fused_geglu_ff_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                    compute_dtype=compute_dtype)
    kw = dict(compute_dtype=compute_dtype)
    return run_kernels(functools.partial(_geglu_ff_kernels, **kw),
                       functools.partial(fused_geglu_ff_plain, **kw),
                       x, ln_scale, ln_bias, w1, b1, w2, b2)


def _geglu_ff_kernels(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                      compute_dtype):
    """The kernel route: check every input, then launch."""
    _check_x(x, "fused_geglu_ff")
    b, t, c = x.shape
    inner = w2.shape[0]
    dev, cdt = x.device, compute_dtype
    _check_vecs([("ln_scale", ln_scale), ("ln_bias", ln_bias)], c, cdt, dev)
    _check_vecs([("b1", b1)], 2 * inner, cdt, dev)
    _check_vecs([("b2", b2)], c, cdt, dev)
    _check_weight(w1, "w1", (c, 2 * inner), cdt, dev)
    _check_weight(w2, "w2", (inner, c), cdt, dev)
    fused_geglu_ff.launches += 1
    m = b * t
    stats = _cuda.norm_stats(x, m, 1, c, 1, 1e-5)
    g = torch.empty((b, t, inner), device=dev, dtype=compute_dtype)
    _cuda.gemm(x, [w1], [g], [b1], M=m, N=inner, T=t, Ci=c,
               norm=_cuda.LAYER_NORM, stats=stats, norm_w=ln_scale,
               norm_b=ln_bias, geglu=True)
    out = torch.empty_like(x)
    _cuda.gemm(g, [w2], [out], [b2], M=m, N=c, T=t, Ci=inner, res=x)
    return out


fused_geglu_ff.launches = 0
