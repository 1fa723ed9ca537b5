"""Fused UNet ResnetBlock (scale_shift FiLM variant): kernel K1.

Replaces the Pallas kernel ``fused_resnet_block`` of
``diff_vits_tpu/ops/fused_resnet.py:133`` (``_kernel`` :68, pallas_call
:174). It computes, for x [B, T, Ci]:

    h = conv3(silu(GN1(x)))                         # k=3 SAME conv, Ci -> Co
    h = conv3(silu(GN2(h) * (1 + scale) + shift))   # scale|shift = film
    out = shortcut(x) + h                           # 1x1 conv or identity

On a CPU tensor the plain PyTorch version below runs (the math of the JAX
package's ``_xla_twin``, :89-130). On a CUDA tensor the hand-written
kernels of ``diff_vits_tpu_torch/csrc`` run, or the call raises; their
gradient is that of the plain version, recomputed
(``ops/kernel_function.py``, JAX's ``defvjp`` through the twin):

    norm_stats(x) -> gemm(conv1: GN1+SiLU prologue, 3 taps) -> norm_stats(h)
    [-> gemm(1x1 shortcut)] -> gemm(conv2: GN2+FiLM+SiLU prologue, 3 taps,
                                    + bias + residual epilogue)

The Pallas kernel holds a whole [T, C] tile in VMEM; a [400, 1024] float32
tile is 1.6 MB against 227 KB of shared memory a block on the H100, so the
GroupNorm statistics come from their own two-pass reduction and the
normalised, activated, shifted conv input is recomputed inside each GEMM's
tile loads instead of being written; the conv input and the GN/FiLM/SiLU
intermediates never reach device memory, only the float32 conv1 output
does. What bounds the block on the H100 at the UNet's shapes (M = B*T of
50-6,400 rows, K = 3*Ci up to 3,072) is not work but the grid and each
block's K-step latency: a 64-row tile per block leaves most of the 132
SMs idle while each walks the whole K. So each conv runs on tensor cores
(bf16, csrc/gemm.cu) with its K split over a thread-block cluster
(``_cuda.gemm_plan``) until three blocks sit on each SM, the split
partials summed in shared memory in a fixed order, and the GN / FiLM /
SiLU prologue runs branch-free inside the tile loads.

Under sequence parallelism (``seq=``, a ``parallel.activations.SeqLevel``:
x holds this rank's frames) both routes give this rank's frames of the
whole block. The plain version takes each GroupNorm's statistics over
every rank's frames and pads each conv's input with the neighbours' frames
(zero frames at the global edges). The kernel route: ``norm_stats`` at
eps 0 gives each rank's (mean, variance), merged over the ranks into the
whole statistics (``SeqLevel.merge_stats``); x gains its neighbours'
frames (none at a global edge, where the GEMM's prologue zero-pads as on
one process) and conv1 runs over them; h1's own frames, their merged
statistics and a second halo feed conv2, whose residual is x's extended
frames; the halo rows of each output are dropped.
"""
from __future__ import annotations

import functools

import torch

from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops.kernel_function import run_kernels


def mm(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``einsum(a.astype(cdt), w.astype(cdt), preferred_element_type=f32)``:
    operands rounded to the compute dtype, products summed in float32."""
    return torch.matmul(a.to(cdt).float(), w.to(cdt).float())


def _group_norm(h, scale, bias, groups: int, eps: float, seq=None):
    if seq is not None:
        return seq.group_norm(h, scale, bias, groups, eps)
    b, t, c = h.shape
    hg = h.reshape(b, t, groups, c // groups)
    mu = hg.mean(dim=(1, 3), keepdim=True)
    var = (hg - mu).square().mean(dim=(1, 3), keepdim=True)
    hn = ((hg - mu) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return hn * scale.float() + bias.float()


def _conv3(h, w, b, cdt, seq=None):
    if seq is None:
        z = torch.zeros_like(h[:, :1])
        hm = torch.cat([z, h[:, :-1]], dim=1)
        hp = torch.cat([h[:, 1:], z], dim=1)
    else:
        ext, _, _ = seq.halo(h, zeros=True)
        hm, hp = ext[:, :-2], ext[:, 2:]
    out = mm(hm, w[0], cdt) + mm(h, w[1], cdt) + mm(hp, w[2], cdt)
    return out + b.float()


def fused_resnet_block_plain(x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                             gn2_bias, w2, b2, w_short=None, b_short=None, *,
                             groups: int = 32, eps: float = 1e-5,
                             compute_dtype=torch.bfloat16, seq=None):
    """Plain PyTorch version of K1, same signature as the kernel route."""
    cdt = compute_dtype
    xf = x.float()
    co = w1.shape[-1]
    film = film.float()
    h = _group_norm(xf, gn1_scale, gn1_bias, groups, eps, seq)
    h = h * torch.sigmoid(h)
    h = _conv3(h, w1, b1, cdt, seq)
    h = _group_norm(h, gn2_scale, gn2_bias, groups, eps, seq)
    h = h * (1.0 + film[:, None, :co]) + film[:, None, co:]
    h = h * torch.sigmoid(h)
    h = _conv3(h, w2, b2, cdt, seq)
    if w_short is not None:
        sc = mm(xf, w_short, cdt) + b_short.float()
    else:
        sc = xf
    return (sc + h).to(x.dtype)


def _check(t: torch.Tensor, name: str, shape, dtype, device,
           contiguous: bool = True) -> None:
    """``dtype`` is one dtype or a tuple of those allowed."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, want one of {dtypes}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_weight(t: torch.Tensor, name: str, shape, cdt, device) -> None:
    """A weight in the compute dtype, read through its strides, so a
    module's parameter is passed as a permuted view. A [3, Ci, Co] conv
    weight's (tap, ci) index must be spanned by one stride: [3, Ci, Co] or
    [Co, Ci, 3] storage."""
    _check(t, name, shape, cdt, device, contiguous=False)
    if t.dim() == 3:
        s_tap, s_ci, _ = t.stride()
        if s_ci != 3 * s_tap and s_tap != t.shape[1] * s_ci:
            raise ValueError(f"{name} has strides {t.stride()}; want "
                             "[3, Ci, Co] or [Co, Ci, 3] storage")


def _check_vecs(named, n: int, cdt, device) -> None:
    """Norm parameters or biases ([n], float32 or the compute dtype) that
    one GEMM launch reads, and so must share one dtype."""
    for name, v in named:
        _check(v, name, (n,), (torch.float32, cdt), device)
    if len({v.dtype for _, v in named}) > 1:
        raise TypeError(f"{', '.join(k for k, _ in named)} must share one "
                        "dtype")


def fused_resnet_block(x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_short=None, b_short=None, *,
                       groups: int = 32, eps: float = 1e-5,
                       compute_dtype=torch.bfloat16, seq=None):
    """Whole scale_shift ResnetBlock. x: [B, T, Ci]; film: [B, 2*Co]
    (silu + Dense of temb, computed outside); w1: [3, Ci, Co]; w2:
    [3, Co, Co]; w_short: [Ci, Co] or None (identity). ``seq``: the
    sequence-parallel level x's frames are of (module docstring).

    CUDA route: x float32 or bfloat16, contiguous; weights in
    ``compute_dtype``, as they are or as views of the modules' parameters
    (``conv.weight.permute(2, 1, 0)`` of an ``nn.Conv1d``,
    ``linear.weight.t()``); film float32; norm parameters and biases
    float32 or ``compute_dtype``, contiguous, a norm's scale and bias in
    one dtype.
    """
    if x.device.type == "cpu":
        return fused_resnet_block_plain(
            x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2, b2,
            w_short, b_short, groups=groups, eps=eps,
            compute_dtype=compute_dtype, seq=seq)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_block runs on cpu or cuda, not "
                         f"{x.device}")
    kw = dict(groups=groups, eps=eps, compute_dtype=compute_dtype, seq=seq)
    return run_kernels(functools.partial(_kernels, **kw),
                       functools.partial(fused_resnet_block_plain, **kw),
                       x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                       gn2_bias, w2, b2, w_short, b_short)


def _kernels(x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias, w2,
             b2, w_short, b_short, *, groups, eps, compute_dtype, seq=None):
    """The kernel route: check every input, then launch."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, Ci], got {tuple(x.shape)}")
    b, t, ci = x.shape
    co = w1.shape[-1]
    dev, f32 = x.device, torch.float32
    _check(x, "x", (b, t, ci), x.dtype, dev)
    _cuda.dtype_flag(x)
    _cuda.dtype_flag(w1)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("compute_dtype must be float32 or bfloat16")
    if ci % groups or co % groups:
        raise ValueError(f"channels {ci}, {co} not divisible by {groups} "
                         "groups")
    cdt = compute_dtype
    _check(film, "film", (b, 2 * co), f32, dev)
    _check_vecs([("gn1_scale", gn1_scale), ("gn1_bias", gn1_bias)], ci, cdt,
                dev)
    _check_vecs([("gn2_scale", gn2_scale), ("gn2_bias", gn2_bias)], co, cdt,
                dev)
    _check_vecs([("b1", b1)], co, cdt, dev)
    _check_vecs([("b2", b2)], co, cdt, dev)
    _check_weight(w1, "w1", (3, ci, co), cdt, dev)
    _check_weight(w2, "w2", (3, co, co), cdt, dev)
    if w_short is not None:
        _check_weight(w_short, "w_short", (ci, co), cdt, dev)
        _check_vecs([("b_short", b_short)], co, cdt, dev)
    elif ci != co:
        raise ValueError("identity shortcut needs Ci == Co")

    fused_resnet_block.launches += 1
    if seq is not None:
        return _seq_kernels(x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale,
                            gn2_bias, w2, b2, w_short, b_short, groups, eps,
                            seq)
    m = b * t
    stats1 = _cuda.norm_stats(x, b, t, ci, groups, eps)
    h1 = torch.empty((b, t, co), device=dev, dtype=f32)
    _cuda.gemm(x, [w1], [h1], [b1], M=m, N=co, T=t, Ci=ci, taps=3,
               norm=_cuda.GROUP_NORM, stats=stats1, norm_w=gn1_scale,
               norm_b=gn1_bias, groups=groups, silu=True)
    stats2 = _cuda.norm_stats(h1, b, t, co, groups, eps)
    res = x
    if w_short is not None:
        res = torch.empty((b, t, co), device=dev, dtype=f32)
        _cuda.gemm(x, [w_short], [res], [b_short], M=m, N=co, T=t, Ci=ci)
    out = torch.empty((b, t, co), device=dev, dtype=x.dtype)
    _cuda.gemm(h1, [w2], [out], [b2], M=m, N=co, T=t, Ci=co, taps=3,
               norm=_cuda.GROUP_NORM, stats=stats2, norm_w=gn2_scale,
               norm_b=gn2_bias, groups=groups, film=film, silu=True, res=res)
    return out


def _seq_kernels(x, film, gn1_scale, gn1_bias, w1, b1, gn2_scale, gn2_bias,
                 w2, b2, w_short, b_short, groups, eps, seq):
    """The kernel route on this rank's frames (module docstring)."""
    b, t, ci = x.shape
    co = w1.shape[-1]
    dev, f32 = x.device, torch.float32
    stats1 = seq.merge_stats(*_cuda.norm_stats(x, b, t, ci, groups, 0.0),
                             ci // groups, eps)
    xe, lo, _ = seq.halo(x, zeros=False)
    te = xe.shape[1]
    h1e = torch.empty((b, te, co), device=dev, dtype=f32)
    _cuda.gemm(xe, [w1], [h1e], [b1], M=b * te, N=co, T=te, Ci=ci, taps=3,
               norm=_cuda.GROUP_NORM, stats=stats1, norm_w=gn1_scale,
               norm_b=gn1_bias, groups=groups, silu=True)
    h1 = h1e[:, lo:lo + t].contiguous()
    stats2 = seq.merge_stats(*_cuda.norm_stats(h1, b, t, co, groups, 0.0),
                             co // groups, eps)
    h1e, _, _ = seq.halo(h1, zeros=False)
    res = xe
    if w_short is not None:
        res = torch.empty((b, te, co), device=dev, dtype=f32)
        _cuda.gemm(xe, [w_short], [res], [b_short], M=b * te, N=co, T=te,
                   Ci=ci)
    out = torch.empty((b, te, co), device=dev, dtype=x.dtype)
    _cuda.gemm(h1e, [w2], [out], [b2], M=b * te, N=co, T=te, Ci=co, taps=3,
               norm=_cuda.GROUP_NORM, stats=stats2, norm_w=gn2_scale,
               norm_b=gn2_bias, groups=groups, film=film, silu=True, res=res)
    return out[:, lo:lo + t].contiguous()


fused_resnet_block.launches = 0
