"""Sequence parallelism of the diffusion UNet over the mesh's ``seq`` axis.

Port of ``diff_vits_tpu/parallel/activations.py``. JAX only annotates the
UNet's [B, T, C] activations (``constrain_seq``) and lets GSPMD partition
the program around them. The port has no GSPMD: inside a
:func:`sequence_parallel` scope whose ``seq`` axis has more than one rank,
``nn.unet1d.UNet1DConditionModel.forward`` takes the whole inputs, keeps
this rank's frames (``SeqLevel.cut``; :func:`constrain_seq` is that cut
of any [B, T, ...] tensor) and runs its forward and backward on them, the
collectives explicit on the ``seq`` ranks of ``parallel.sharding.Layout``.
Outside a scope, or with one ``seq`` rank, nothing changes.

The frames (:class:`SeqShard`): T frames split into ``n`` blocks whose
boundaries fall on multiples of 2^(levels - 1) (8 for the UNet's four
blocks), so that each k3 stride-2 ``Downsample1D`` keeps the same frames
on every rank as on one process; every rank but the last takes
``ceil(ceil(T / n) / 8) * 8`` frames, the last the rest. A T that leaves
the last rank no frame raises ValueError (T is never padded: padding would
change the GroupNorm statistics, and JAX does not pad). At level l the
rank holds its level-0 boundaries divided by 2^l, the last rank up to
``T_l = ceil(T_{l-1} / 2)``; ``Upsample1D`` (nearest, to the skip's
length) then reads only local frames and lands on the skip's shard.

Where the UNet needs other ranks (:class:`SeqLevel`):

* k3 SAME convolutions (``conv_in``, ``conv_out``, the resnets' convs,
  ``Upsample1D``'s, ``Downsample1D``'s stride-2 one) read a one-frame halo
  of each neighbour (:meth:`SeqLevel.halo`; one all-gather of every
  rank's first and last frame; its backward sends the halo's gradient home
  the same way). At the sequence's global edges the padding is the conv's
  own zero padding: zero frames of the conv's input on the plain route;
  no frame at all on K1's kernel route, whose GEMM prologue zero-pads
  after GroupNorm and SiLU (``ops/fused_resnet.py``).
* GroupNorm (the resnets', ``Transformer1D.norm``, ``conv_norm_out``)
  takes its statistics over every rank's frames, never over a halo:
  two all-reduced sums, of x and of (x - mean)^2, as the one-process two
  pass computes them (:meth:`SeqLevel.group_norm`); K1's kernel route
  merges each rank's (count, mean, M2) from ``norm_stats`` at eps 0
  (Chan's merge, :meth:`SeqLevel.merge_stats`).
* self-attention runs the ring of ``parallel/ring_attention.py`` over the
  ``seq`` ranks (K8 blocks on the card); cross-attention (local queries,
  the whole context) and everything per frame need nothing.

Moving data: every exchange goes through ``sharding.Group``, which stages
a CUDA tensor through the host under gloo.

Gradients: each collective is an autograd function whose backward is the
matching collective (an all-reduce's is an all-reduce, a halo's sends the
halo's gradient home), so the UNet's parameter gradients on a rank are
its frames' share; ``Plan.reduce_grads`` sums them over ``seq``
(``models/diff_vits.py`` says how the loss is split so that the sum is
one process's gradient).
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.parallel import mesh as mesh_lib
from diff_vits_tpu_torch.parallel.sharding import Group, Layout

_state = threading.local()

MeshLike = Union[Layout, Mapping[str, int]]


def _current():
    return getattr(_state, "cfg", None)


def _names(mesh: MeshLike):
    return tuple(mesh.mesh if isinstance(mesh, Layout) else mesh)


def enable_sequence_parallel(mesh: MeshLike, data_axis: str = "data",
                             seq_axis: str = "seq") -> None:
    """Shard the diffusion UNet's frames over ``seq_axis`` of ``mesh`` (a
    ``sharding.Layout``, or a {axis: size} mesh whose Layout is built here:
    every rank must then call it) until :func:`disable_sequence_parallel`.
    ValueError when the mesh has no ``seq_axis``. ``data_axis`` is JAX's
    signature's: a rank's rows are already its data rows here."""
    names = _names(mesh)
    if seq_axis not in names:
        raise ValueError(f"mesh has no '{seq_axis}' axis: {names}")
    layout = mesh if isinstance(mesh, Layout) else Layout(mesh,
                                                          mesh_lib.rank())
    _state.cfg = (layout, seq_axis)


def disable_sequence_parallel() -> None:
    _state.cfg = None


@contextlib.contextmanager
def sequence_parallel(mesh: Optional[MeshLike], data_axis: str = "data",
                      seq_axis: str = "seq"):
    """Scoped activation; ``mesh=None`` gives a scope in which nothing is
    sharded (the duration predictor's UNet runs whole in one)."""
    prev = _current()
    if mesh is not None:
        enable_sequence_parallel(mesh, data_axis, seq_axis)
    else:
        _state.cfg = None
    try:
        yield
    finally:
        _state.cfg = prev


def seq_group() -> Optional[Group]:
    """The ``seq`` ranks' group when a scope with more than one of them is
    active, else None."""
    cfg = _current()
    if cfg is None:
        return None
    layout, seq_axis = cfg
    group = layout.group(seq_axis)
    return group if group.size > 1 else None


def shard(length: int, levels: int = 1) -> Optional["SeqLevel"]:
    """Level 0 of the :class:`SeqShard` of ``length`` frames over the
    active scope's ``seq`` ranks, for a UNet of ``levels`` blocks; None
    outside a scope (or with one ``seq`` rank)."""
    group = seq_group()
    if group is None:
        return None
    return SeqShard(group, length, levels).level(0)


def constrain_seq(x: torch.Tensor, align: int = 1) -> torch.Tensor:
    """This rank's frames of a whole [B, T, ...] ``x`` (boundaries on
    multiples of ``align``, as :class:`SeqShard` lays them out); ``x``
    itself unless a scope with more than one ``seq`` rank is active. The
    slice's gradient is this rank's share of the whole one."""
    group = seq_group()
    if group is None or getattr(x, "ndim", 0) < 2:
        return x
    levels = max(1, int(align).bit_length())
    return SeqShard(group, x.shape[1], levels).level(0).cut(x)


# -- the frames ----------------------------------------------------------

class SeqShard:
    """``length`` frames over ``group`` for a UNet of ``levels`` blocks:
    ``bounds[l][r]`` is rank r's (start, stop) at level l, ``lengths[l]``
    the whole length there."""

    def __init__(self, group: Group, length: int, levels: int = 1):
        n = group.size
        unit = 2 ** (levels - 1)
        per = -(-(-(-length // n)) // unit) * unit
        if length - (n - 1) * per <= 0:
            raise ValueError(
                f"{length} frames leave the last of {n} seq ranks no frame "
                f"(blocks of {per}, on multiples of {unit}); sequence "
                "parallelism needs more frames or fewer seq ranks")
        self.group, self.levels = group, levels
        self.lengths = [length]
        for _ in range(1, levels):
            self.lengths.append(-(-self.lengths[-1] // 2))
        self.bounds = [[((r * per) >> lv, ((r + 1) * per) >> lv if r < n - 1
                         else self.lengths[lv]) for r in range(n)]
                       for lv in range(levels)]

    def level(self, lv: int) -> "SeqLevel":
        return SeqLevel(self, lv)


class SeqLevel:
    """This rank's frames at level ``lv`` of a :class:`SeqShard`, and the
    collectives of the UNet's sites on them."""

    def __init__(self, plan: SeqShard, lv: int):
        self.plan, self.lv = plan, lv
        self.group = plan.group
        self.start, self.stop = plan.bounds[lv][plan.group.index]
        self.length = plan.lengths[lv]
        self.sizes = [b - a for a, b in plan.bounds[lv]]

    @property
    def first(self) -> bool:
        return self.group.index == 0

    @property
    def last(self) -> bool:
        return self.group.index == self.group.size - 1

    def up(self) -> "SeqLevel":
        return self.plan.level(self.lv - 1)

    def cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's frames of a whole ``x`` along ``dim``."""
        if x.shape[dim] != self.length:
            raise ValueError(f"cut: {x.shape[dim]} frames, the shard is of "
                             f"{self.length}")
        return x.narrow(dim, self.start, self.stop - self.start)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's frames [B, T_r, ...] joined along dim 1 (no
        gradient): the whole tensor."""
        pad = max(self.sizes)
        buf = F.pad(x.detach(), (0, 0) * (x.dim() - 2)
                    + (0, pad - x.shape[1])) if x.shape[1] < pad \
            else x.detach()
        parts = _all_gather(self.group, buf)
        return torch.cat([p[:, :n] for p, n in zip(parts, self.sizes)], 1)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ``seq`` ranks; its gradient is the sum
        of theirs."""
        return _AllReduce.apply(t, self.group)

    def halo(self, x: torch.Tensor, zeros: bool = True
             ) -> Tuple[torch.Tensor, int, int]:
        """[B, T, C] -> ([left, x, right], l, r): the left neighbour's last
        frame and the right one's first, l and r frames of them (1 each
        where the neighbour exists). At a global edge: a zero frame with
        ``zeros`` (counted in l / r), nothing without."""
        ext = _Halo.apply(x, self.group, zeros)
        left = int(zeros or not self.first)
        right = int(zeros or not self.last)
        return ext, left, right

    def conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        """A k3, padding-1 ``nn.Conv1d`` (any stride) on this rank's frames
        of channel-last ``x``, over the neighbours' halo and zero frames at
        the global edges: this rank's frames of the whole conv."""
        if conv.kernel_size != (3,) or conv.padding != (1,):
            raise ValueError("sequence-parallel convs are k3, padding 1")
        ext, _, _ = self.halo(x, zeros=True)
        y = F.conv1d(ext.transpose(1, 2), conv.weight, conv.bias,
                     stride=conv.stride)
        return y.transpose(1, 2).contiguous()

    def group_norm(self, x: torch.Tensor, weight, bias, groups: int,
                   eps: float) -> torch.Tensor:
        """GroupNorm of channel-last ``x`` with the statistics of every
        rank's frames (two passes: the all-reduced sum, then the
        all-reduced sum of squared deviations), in float32; x's dtype out,
        float32 under autocast (as autocast runs ``nn.GroupNorm``)."""
        b, t, c = x.shape
        xg = x.float().reshape(b, t, groups, c // groups)
        frames = torch.tensor([float(t)], device=x.device)
        s = self.all_reduce(torch.cat([xg.sum(dim=(1, 3)).reshape(-1),
                                       frames]))
        n = s[-1] * (c // groups)
        mu = (s[:-1] / n).view(b, 1, groups, 1)
        d = xg - mu
        var = (self.all_reduce(d.square().sum(dim=(1, 3)).reshape(-1))
               / n).view(b, 1, groups, 1)
        y = (d * torch.rsqrt(var + eps)).reshape(b, t, c)
        if weight is not None:
            y = y * weight.float() + bias.float()
        return y if torch.is_autocast_enabled(x.device.type) \
            else y.to(x.dtype)

    def merge_stats(self, mean: torch.Tensor, rstd0: torch.Tensor,
                    per_frame: int, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole-sequence (mean, rstd) from this rank's ``norm_stats`` at
        eps 0 (mean, 1 / sqrt(var)) over its frames, each frame
        ``per_frame`` values: every rank's (count, mean, M2) merged
        (Chan), never through rstd + eps. No gradient."""
        var = torch.where(torch.isinf(rstd0), torch.zeros_like(rstd0),
                          rstd0.float() ** -2)
        every = _all_gather(self.group, torch.stack([mean.float(), var]))
        counts = torch.tensor([float(s * per_frame) for s in self.sizes],
                              device=mean.device)[:, None]
        means = torch.stack([e[0] for e in every])
        m2 = torch.stack([e[1] for e in every]) * counts
        total = counts.sum()
        mu = (means * counts).sum(0) / total
        var = (m2.sum(0) + ((means - mu) ** 2 * counts).sum(0)) / total
        return mu.contiguous(), torch.rsqrt(var + eps).contiguous()

    def upsample(self, x: torch.Tensor, output_size: int) -> torch.Tensor:
        """Nearest upsampling of this rank's frames (level ``lv``) to the
        frames it holds of the whole ``output_size`` at level ``lv - 1``;
        every source frame is local (the shard boundaries double)."""
        up = self.up()
        if up.length != output_size:
            raise ValueError(f"upsample to {output_size} frames from level "
                             f"{self.lv} (whole {self.length}), whose "
                             f"upper level has {up.length}")
        idx = (torch.arange(up.start, up.stop, device=x.device)
               * self.length) // output_size - self.start
        return x[:, idx]


def _all_gather(group: Group, t: torch.Tensor) -> List[torch.Tensor]:
    """``group.all_gather`` with half tensors sent as float32."""
    low = t.dtype in (torch.float16, torch.bfloat16)
    parts = group.all_gather(t.float() if low else t)
    return [p.to(t.dtype) for p in parts] if low else parts


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _Halo(torch.autograd.Function):
    """[B, T, C] -> [left, x, right] (see :meth:`SeqLevel.halo`); the
    backward adds the halo frames' gradients to their owners' edge
    frames."""

    @staticmethod
    def forward(ctx, x, group: Group, zeros: bool):
        i, n = group.index, group.size
        every = _all_gather(group, torch.stack([x[:, 0], x[:, -1]], 1))
        zero = torch.zeros_like(x[:, :1])
        left = every[i - 1][:, 1:2] if i > 0 else (zero if zeros else None)
        right = (every[i + 1][:, 0:1] if i < n - 1
                 else (zero if zeros else None))
        ctx.group, ctx.l, ctx.r = group, int(left is not None), \
            int(right is not None)
        ctx.t = x.shape[1]
        return torch.cat([p for p in (left, x, right) if p is not None],
                         1).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, l, t = ctx.group, ctx.l, ctx.t
        i, n = group.index, group.size
        gx = g[:, l:l + t].clone()
        zero = torch.zeros_like(g[:, :1])
        gl = g[:, :1] if l else zero
        gr = g[:, l + t:l + t + 1] if ctx.r else zero
        every = _all_gather(group, torch.cat([gl, gr], 1))
        if i > 0:               # my first frame is rank i-1's right halo
            gx[:, :1] += every[i - 1][:, 1:2]
        if i < n - 1:           # my last frame is rank i+1's left halo
            gx[:, -1:] += every[i + 1][:, 0:1]
        return gx, None, None
