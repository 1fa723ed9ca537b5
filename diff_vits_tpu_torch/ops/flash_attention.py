"""Scaled-dot-product attention with a key-padding mask: kernel K8.

Replaces the flash-attention route of ``diff_vits_tpu/ops/flash_attention.py``
(``sdpa`` :81, which calls the TPU flash-attention kernels of
``jax.experimental.pallas.ops.tpu.flash_attention`` at :91 and :118: a
forward kernel and its own dq and dkv backward kernels). For q [B, H, T, d],
k and v [B, H, S, d] and a keep mask [B, S] (True = keep) or None:

    out = softmax(sm_scale * q k^T + bias) v,  bias = 0 kept, -10000 not

The bias is the additive -10000 of the JAX package's ``xla_sdpa`` (:50-57)
and of the UNet's ``CrossAttention`` twin; JAX's kernel masks with segment
ids instead, and the two agree on every row with a kept key.

``sdpa`` runs the plain PyTorch version ``sdpa_plain`` (float32 arithmetic,
the input dtype out) on a CPU tensor, and when ``use_flash`` is off;
autograd of it is the CPU backward. On a CUDA tensor with ``use_flash`` it
runs ``FlashSDPA``: the forward launches the K8 forward kernel
(``csrc/flash_attention.cu``) and saves the output and the float32 row
log-sum-exp; the backward launches the K8 backward kernels on them, as the
JAX kernel ships its own backward (nothing plain is recomputed). A kernel
that does not build or launch raises. ``sdpa_backward_plain`` writes that
backward out in PyTorch, for the tests.

Which kernels run is a rule of dtype and head dim (``_cuda.flash_plan``):
bfloat16 at a head dim up to 64 (``MMA_HEAD_DIMS``; every gated site of
the training step has 8, 16 or 32) runs the tensor-core kernels
(``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
``flash_bwd_dkdv_mma_kernel``); float32 (the exact parity route) and
bfloat16 above 64 run the FMA kernels. The tensor-core kernels read rows
in 16-byte chunks: a q, k, v or o that does not start 16-byte aligned or
whose strides are not multiples of 8 elements is refused (ValueError)
before any launch; the gradient dout is copied instead, since autograd
hands it over in any layout. Besides ``launches``, each launcher counts
its launches by route in ``mma_launches`` and ``fma_launches``, and the
bfloat16 launches the head-dim rule sends to the FMA kernels in
``wide_bf16_launches`` (:func:`route_counts`).

The route is opt-in in the modules, as in JAX (``use_flash`` defaults off
there): they carry a ``use_flash`` flag (``nn/unet1d.set_use_flash``),
test ``flash_ok`` on their shapes and call ``sdpa`` only when it passes;
``train.trainer.Trainer`` sets the flag on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from diff_vits_tpu_torch.ops import _cuda

HEAD_DIMS = _cuda.FLASH_HEAD_DIMS
MMA_HEAD_DIMS = _cuda.FLASH_MMA_HEAD_DIMS
MASKED_BIAS = -10000.0
MIN_SCORES = 128 * 128 * 4     # JAX's gate: T * S below this stays plain


def flash_ok(q_shape, k_shape, use_flash: bool = False) -> bool:
    """The shape gate of JAX's ``flash_ok`` (:60-78): opt-in, head dim <=
    128, T * S >= 128 * 128 * 4. JAX's TPU-backend test is ``sdpa``'s "the
    tensor is on CUDA" here."""
    if not use_flash:
        return False
    t, d = q_shape[2], q_shape[3]
    s = k_shape[2]
    return d <= 128 and t * s >= MIN_SCORES


def bias_to_keep_mask(attention_bias: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
    """[B, X, S] additive 0 / -10000 key bias -> bool [B, S] keep mask
    (:123-131): the UNet builds key-padding biases only, so row 0 holds all
    of it."""
    if attention_bias is None:
        return None
    return attention_bias[:, 0, :] > -5000.0


def _key_bias(keep: torch.Tensor) -> torch.Tensor:
    """[B, S] keep mask -> [B, 1, 1, S] float32 additive bias."""
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, zero + MASKED_BIAS)[:, None, None, :]


def _scores(q, k, keep, sm_scale):
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if keep is not None:
        scores = scores + _key_bias(keep)
    return scores


def sdpa_plain(q, k, v, keep: Optional[torch.Tensor] = None, *,
               sm_scale: float, with_lse: bool = False):
    """Plain PyTorch version of K8 (differentiable): float32 scores, bias,
    softmax and PV from q, k, v as given, autocast or not; the output in
    q's dtype, and with ``with_lse`` also the float32 row log-sum-exp
    [B, H, T]."""
    with torch.autocast(q.device.type, enabled=False):
        scores = _scores(q, k, keep, sm_scale)
        out = torch.matmul(torch.softmax(scores, dim=-1), v.float())
        out = out.to(q.dtype)
        if not with_lse:
            return out
        return out, torch.logsumexp(scores, dim=-1)


def sdpa_backward_plain(q, k, v, o, lse, do, keep=None, *, sm_scale: float):
    """K8's backward written out in PyTorch (float32): p from the saved
    log-sum-exp, delta = rowsum(do * o), ds = p (do v^T - delta). Returns
    (dq, dk, dv) in q's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        return _backward_plain(q, k, v, o, lse, do, keep, sm_scale)


def _backward_plain(q, k, v, o, lse, do, keep, sm_scale):
    p = torch.exp(_scores(q, k, keep, sm_scale) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, k.float()) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def sdpa(q, k, v, keep: Optional[torch.Tensor] = None, *, sm_scale: float,
         use_flash: bool = False) -> torch.Tensor:
    """Scaled-dot-product attention. q [B, H, T, d]; k, v [B, H, S, d];
    keep bool [B, S] or None. Returns [B, H, T, d] in q's dtype,
    differentiable on both routes. K8 runs when ``use_flash`` is set and q
    is on CUDA; q, k, v in one dtype (float32 or bfloat16), any strides with
    a unit last stride (others are copied once). The shape gate
    ``flash_ok`` is the caller's: the modules test it before they call."""
    if q.device.type == "cpu" or not use_flash:
        return sdpa_plain(q, k, v, keep, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa runs on cpu or cuda, not {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return FlashSDPA.apply(q, k, v, keep, sm_scale)


class FlashSDPA(torch.autograd.Function):
    """K8 forward, K8 backward; under autocast both run in the forward's
    autocast state on the tensors as they arrive."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, keep, sm_scale):
        o, lse = flash_attention_forward(q, k, v, keep, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, keep)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, o, lse, keep = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, keep,
                                              ctx.sm_scale)
        return dq, dk, dv, None, None


# -- the kernel launchers -----------------------------------------------

def _view(t: Optional[torch.Tensor]) -> _cuda.View:
    if t is None:
        return _cuda.View()
    return _cuda.View(t.data_ptr(), *t.stride()[:3])


def _check_qkv(q, k, v):
    """Shapes, device and dtype K8 takes (the head dim is the plan's);
    returns (b, h, t, s, d)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, d]")
    b, h, t, d = q.shape
    s = k.shape[2]
    if tuple(k.shape) != (b, h, s, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, {h}, S, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q")
        if x.dtype != q.dtype:
            raise TypeError(f"q, k, v must share a dtype, got {q.dtype} and "
                            f"{x.dtype} ({name})")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit last stride")
    _cuda.dtype_flag(q)
    return b, h, t, s, d


def _keep(keep, b, s, device):
    if keep is None:
        return None
    if tuple(keep.shape) != (b, s) or keep.device != device:
        raise ValueError(f"keep must be [{b}, {s}] on {device}, got "
                         f"{tuple(keep.shape)} on {keep.device}")
    return keep.to(torch.bool).contiguous()


def mma_view_ok(x: torch.Tensor) -> bool:
    """Whether the tensor-core kernels can read or write ``x``: their
    16-byte cp.async chunks and bf16-pair loads need a start 16-byte
    aligned and batch, head and row strides in multiples of 8 elements."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in x.stride()[:3])


def check_mma_views(**views) -> None:
    """Raise ValueError on a view :func:`mma_view_ok` refuses."""
    for name, x in views.items():
        if not mma_view_ok(x):
            offset = x.data_ptr() % 16
            raise ValueError(
                f"{name}: the tensor-core flash-attention kernels need a "
                f"16-byte aligned start and batch, head and row strides in "
                f"multiples of 8 elements; got {offset} bytes past 16 and "
                f"strides {tuple(x.stride())}")


def _args(dims, plan, q, k, v, keep, lse, sm_scale, **views):
    b, h, t, s, d = dims
    a = _cuda.FlashArgs()
    a.q, a.k, a.v = _view(q), _view(k), _view(v)
    for name, x in views.items():
        setattr(a, name, _view(x))
    a.lse = lse.data_ptr()
    a.keep = _cuda.ptr(keep)
    a.B, a.H, a.T, a.S, a.D = b, h, t, s, d
    a.dt, a.scale = _cuda.dtype_flag(q), float(sm_scale)
    a.qrows, a.krows, a.mma = plan.q_rows, plan.k_rows, int(plan.tensor_cores)
    return a


def _count(launcher, plan, dtype) -> None:
    launcher.launches += 1
    if plan.tensor_cores:
        launcher.mma_launches += 1
    else:
        launcher.fma_launches += 1
        launcher.wide_bf16_launches += dtype == torch.bfloat16


def flash_attention_forward(q, k, v, keep, sm_scale):
    """One launch of K8's forward: (o like q, lse [B, H, T] float32)."""
    dims = b, h, t, s, d = _check_qkv(q, k, v)
    keep = _keep(keep, b, s, q.device)
    plan = _cuda.flash_plan(b, t, s, h, d, q.dtype)
    o = torch.empty_like(q)
    if plan.tensor_cores:
        check_mma_views(q=q, k=k, v=v, o=o)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    a = _args(dims, plan, q, k, v, keep, lse, sm_scale, o=o)
    _cuda.check(_cuda.fn("flash_attention.cu", "dvt_flash_forward")(
        ctypes.byref(a), _cuda.stream_ptr(q)),
        f"flash-attention forward at {tuple(q.shape)}, S={s}")
    _count(flash_attention_forward, plan, q.dtype)
    return o, lse


def flash_attention_backward(q, k, v, o, lse, do, keep, sm_scale):
    """K8's backward (the dQ kernel, which also writes delta, then the
    dK/dV kernel): (dq, dk, dv) like q, k, v, layouts included."""
    dims = b, h, t, s, d = _check_qkv(q, k, v)
    keep = _keep(keep, b, s, q.device)
    plan = _cuda.flash_plan(b, t, s, h, d, q.dtype)
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    if do.shape != q.shape or o.shape != q.shape or o.stride(-1) != 1:
        raise ValueError("o and do must be shaped like q, unit last stride")
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [{b}, {h}, {t}] float32")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if plan.tensor_cores:
        if not mma_view_ok(do):   # autograd's layout: a copy they can read
            do = do.clone(memory_format=torch.contiguous_format)
        check_mma_views(q=q, k=k, v=v, o=o, dq=dq, dk=dk, dv=dv)
    delta = torch.empty_like(lse)
    a = _args(dims, plan, q, k, v, keep, lse, sm_scale, o=o, dout=do, dq=dq,
              dk=dk, dv=dv)
    a.delta = delta.data_ptr()
    _cuda.check(_cuda.fn("flash_attention.cu", "dvt_flash_backward")(
        ctypes.byref(a), _cuda.stream_ptr(q)),
        f"flash-attention backward at {tuple(q.shape)}, S={s}")
    _count(flash_attention_backward, plan, q.dtype)
    return dq, dk, dv


ROUTE_COUNTERS = ("mma_launches", "fma_launches", "wide_bf16_launches")
LAUNCHERS = (flash_attention_forward, flash_attention_backward)


def route_counts():
    """{"flash_attention_forward.mma_launches": n, ...}: each launcher's
    launches by route since the last :func:`reset_route_counts`."""
    return {f"{fn.__name__}.{c}": getattr(fn, c)
            for fn in LAUNCHERS for c in ROUTE_COUNTERS}


def reset_route_counts() -> None:
    for fn in LAUNCHERS:
        for c in ROUTE_COUNTERS:
            setattr(fn, c, 0)


flash_attention_forward.launches = 0
flash_attention_backward.launches = 0
reset_route_counts()
