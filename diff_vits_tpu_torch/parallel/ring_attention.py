"""Ring (sequence-parallel) attention over a process group.

Port of ``diff_vits_tpu/parallel/ring_attention.py``: q, k and v are
sharded on their sequence axis over the ranks of a group; q stays, and k,
v and the key mask go once around the ring (``sharding.Group.shift``, a
send to the next rank and a receive from the previous one, through the
host under gloo), each block's attention merged into the running result by
its log-sum-exp, so no rank holds the whole [T, S] scores.

Each block is one call of K8 (``ops/flash_attention.py``) on the card:
``flash_attention_forward`` returns the block's normalised output and its
float32 row log-sum-exp, which the merge needs; on the CPU it is the plain
``sdpa_plain`` (with ``with_lse``). K8 masks a key with a -10000 bias, so
an item that keeps no key of a block gets a finite log-sum-exp there; the
merge sets it to -inf (that block adds exactly 0, as JAX's
``where(keep, p, 0)``), and a row with no kept key anywhere returns 0, as
JAX's ``o / max(l, 1e-30)`` does.

The backward (:class:`_Ring`) is a second trip round the ring: k, v, the
mask and the running dK, dV go round together; each block's dQ, dK and dV
come from K8's backward kernels (``flash_attention_backward``; on the CPU
its plain twin ``_backward_plain``) given the **global** output and
log-sum-exp, so that p and delta = rowsum(dO * O) are the whole row's; dQ
sums on the rank, dK and dV reach their home rank after the last hop. JAX
gets the same from the transpose of ``lax.scan`` and ``ppermute``. A row
that keeps no key gets log-sum-exp +inf in the backward, so its p, and
every gradient through it, is 0.

A forward launches K8's forward n times (one a block) and its backward
n times (dQ and dK/dV kernels one launch pair a block), n the group's
size.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch

from diff_vits_tpu_torch.ops.flash_attention import (
    _backward_plain, flash_attention_backward, flash_attention_forward,
    sdpa_plain)
from diff_vits_tpu_torch.parallel import mesh as mesh_lib
from diff_vits_tpu_torch.parallel.sharding import Group, Layout


def _block(q, k, v, keep, scale):
    """(o like q, lse float32 [B, H, Tq]) of one block; lse -inf for an
    item that keeps none of the block's keys."""
    if q.device.type == "cuda":
        o, lse = flash_attention_forward(q, k, v, keep, scale)
    else:
        o, lse = sdpa_plain(q, k, v, keep, sm_scale=scale, with_lse=True)
    if keep is not None:
        lse = torch.where(keep.any(dim=1)[:, None, None], lse,
                          torch.full_like(lse, -torch.inf))
    return o, lse


def _block_backward(q, k, v, o, lse, do, keep, scale):
    if q.device.type == "cuda":
        return flash_attention_backward(q, k, v, o, lse, do, keep, scale)
    with torch.autocast(q.device.type, enabled=False):
        return _backward_plain(q, k, v, o, lse, do, keep, scale)


def _hop(group: Group, tensors, sizes, src: int):
    """``tensors`` one hop round the ring: what rank ``src`` of the group
    (whose blocks are ``sizes[src]`` keys long) held before."""
    likes = []
    for t in tensors:
        shape = list(t.shape)
        shape[2 if t.dim() == 4 else 1] = sizes[src]
        likes.append(torch.empty(shape, dtype=t.dtype, device="meta"))
    return group.shift_many(tensors, likes)


class _Ring(torch.autograd.Function):

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, keep, group, scale, sizes):
        n, i = group.size, group.index
        o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse_acc = torch.full(q.shape[:3], -torch.inf, dtype=torch.float32,
                             device=q.device)
        blk = [k, v] + ([keep] if keep is not None else [])
        for s in range(n):
            kb, vb = blk[0], blk[1]
            ob, lb = _block(q, kb, vb, blk[2] if keep is not None else None,
                            scale)
            lse_new = torch.logaddexp(lse_acc, lb)
            safe = torch.where(torch.isneginf(lse_new),
                               torch.zeros_like(lse_new), lse_new)
            o_acc = (o_acc * torch.exp(lse_acc - safe)[..., None]
                     + ob.float() * torch.exp(lb - safe)[..., None])
            lse_acc = lse_new
            if s < n - 1:
                blk = _hop(group, blk, sizes, (i - s - 1) % n)
        o = o_acc.to(q.dtype)
        # no kept key in the whole row: o is 0, and p 0 in the backward
        lse = torch.where(torch.isneginf(lse_acc),
                          torch.full_like(lse_acc, torch.inf), lse_acc)
        ctx.save_for_backward(q, k, v, keep, o, lse)
        ctx.group, ctx.scale, ctx.sizes = group, scale, sizes
        return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, keep, o, lse = ctx.saved_tensors
        group, scale, sizes = ctx.group, ctx.scale, ctx.sizes
        n, i = group.size, group.index
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        blk = [k, v] + ([keep] if keep is not None else [])
        for s in range(n):
            dqb, dkb, dvb = _block_backward(
                q, blk[0], blk[1], o, lse, do,
                blk[2] if keep is not None else None, scale)
            dq += dqb.float()
            acc[0] += dkb.float()
            acc[1] += dvb.float()
            src = (i - s - 1) % n
            if s < n - 1:
                moved = _hop(group, blk + acc, sizes, src)
                blk, acc = moved[:len(blk)], moved[len(blk):]
            else:               # the last hop brings dK, dV home
                acc = _hop(group, acc, sizes, src)
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep_mask: Optional[torch.Tensor] = None, *,
                   group: Group, scale: Optional[float] = None,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Attention of this rank's queries over every rank's keys. q
    [B, H, Tq, d], k and v [B, H, Tk, d] are the local shards of a
    sequence sharded over ``group``; ``keep_mask`` [B, Tk] bool marks the
    local keys kept (None: all). ``sizes``: every rank's Tk in the group's
    order (default: all equal to this rank's). Returns [B, H, Tq, d] in q's
    dtype, the whole sequence's softmax attention (scale d^-0.5 unless
    given) for the local queries; differentiable. Every rank of ``group``
    must call it."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    sizes = list(sizes) if sizes is not None else [k.shape[2]] * group.size
    if len(sizes) != group.size or sizes[group.index] != k.shape[2]:
        raise ValueError(f"sizes {sizes} do not fit this rank's {k.shape[2]} "
                         f"keys over {group.size} ranks")
    if keep_mask is not None:
        keep_mask = keep_mask.to(torch.bool)
    return _Ring.apply(q, k, v, keep_mask, group, scale, sizes)


class _Scatter(torch.autograd.Function):
    """A whole tensor held by every rank -> this rank's block of dim 2;
    the backward gathers every rank's gradient block (the caller's loss is
    the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        t = x.shape[2] // group.size
        return x.narrow(2, group.index * t, t).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.group.all_gather(g.contiguous()), 2), None


class _Gather(torch.autograd.Function):
    """Every rank's block of dim 2 -> the whole tensor; the backward keeps
    this rank's block of the (same on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return torch.cat(group.all_gather(x.contiguous()), 2)

    @staticmethod
    def backward(ctx, g):
        t = g.shape[2] // ctx.group.size
        return g.narrow(2, ctx.group.index * t, t).contiguous(), None


def make_ring_attention(mesh: Union[Layout, Mapping[str, int]],
                        axis_name: str = "seq"):
    """``f(q, k, v, keep_mask)`` on whole q, k, v [B, H, T, d] and
    keep_mask [B, T] held alike by every rank: each rank takes its block
    of T over ``axis_name`` (T must divide evenly, as JAX's ``shard_map``
    requires), runs :func:`ring_attention`, and every rank gets the whole
    output back; gradients reach the whole inputs on every rank. ``mesh``
    is a ``sharding.Layout`` or a {axis: size} mesh (its Layout is built
    here: every rank must call this)."""
    layout = mesh if isinstance(mesh, Layout) else Layout(mesh,
                                                          mesh_lib.rank())
    group = layout.group(axis_name)

    def fn(q, k, v, keep_mask=None):
        t = q.shape[2]
        if t % group.size:
            raise ValueError(f"sequence of {t} does not split over "
                             f"{group.size} '{axis_name}' ranks")
        local = [_Scatter.apply(x, group) for x in (q, k, v)]
        keep = None
        if keep_mask is not None:
            n = t // group.size
            keep = keep_mask[:, group.index * n:(group.index + 1) * n]
        o = ring_attention(*local, keep, group=group)
        return _Gather.apply(o, group)

    return fn
