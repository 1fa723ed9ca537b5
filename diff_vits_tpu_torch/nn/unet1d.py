"""Conditional 1-D UNet denoiser, channel-last [B, T, C].

Port of ``diff_vits_tpu/nn/unet1d.py``: the attention and feed-forward
blocks, the adaptive norms (``AdaLayerNorm``, ``AdaGroupNorm``,
``SpatialNorm``, :225-299), ``Transformer1D`` and ``DualTransformer1D``
(:302-373), ``ResnetBlock1D`` (scale_shift FiLM), down/up sampling, the
five block types the model uses and ``UNet1DConditionModel`` with its
``emb=`` and ``embedding_request`` paths (:700-849). The other block
types are in ``nn/unet1d_blocks``. Submodules carry the flax names
(``down_0.resnet_1``, ``attn_0.block_0.attn2``, ...) so
``utils/convert.py`` maps the JAX package's parameters mechanically.

Routing: in eval mode, ``ResnetBlock1D`` and ``BasicTransformerBlock``
send every call that passes the JAX package's shape gates (:157-168,
:397-406) through the fused ops of ``diff_vits_tpu_torch.ops``, which run
their CUDA kernels on the card and their plain PyTorch versions on the
CPU; there is no batch cut-off. ``use_fused=False``, training mode (as the
JAX modules turn the fused route off when ``deterministic=False``) and a
call failing the gate take the unfused PyTorch formulation (the JAX
package's XLA path). The UNet's dropout is 0 on every path, so both routes
compute the same function.

Sequence parallelism: inside a ``parallel.activations.sequence_parallel``
scope whose ``seq`` axis has more than one rank, ``UNet1DConditionModel``
takes the whole inputs, keeps this rank's frames and returns this rank's
frames of the output (``activations.SeqShard`` lays them out). Each block
gets the ``seq`` level it runs at (an ``activations.SeqLevel``; None
outside a scope): its k3 convs read the neighbours' halo, its GroupNorms
take every rank's statistics, its self-attention runs the ring of
``parallel.ring_attention`` (K8 blocks on the card), and the fused ops
take the level as ``seq=`` (K1's halos and merged statistics, K2's ring
core); cross-attention and the per-frame work are local.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.nn.embeddings import (
    TextTimeEmbedding, TimestepEmbedding, Timesteps)
from diff_vits_tpu_torch.nn.layers import Conv1d
from diff_vits_tpu_torch.nn.remat import remat_call
from diff_vits_tpu_torch.ops import (
    fused_cross_attention, fused_geglu_ff, fused_resnet_block,
    fused_self_attention)
from diff_vits_tpu_torch.ops.flash_attention import (
    bias_to_keep_mask, flash_ok, sdpa)
from diff_vits_tpu_torch.parallel import activations
from diff_vits_tpu_torch.parallel.moe import MoEFeedForward
from diff_vits_tpu_torch.parallel.ring_attention import ring_attention


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor, seq=None
                ) -> torch.Tensor:
    if seq is not None:
        return seq.group_norm(x, norm.weight, norm.bias, norm.num_groups,
                              norm.eps)
    return norm(x.transpose(1, 2)).transpose(1, 2)


def _conv(conv: nn.Conv1d, x: torch.Tensor, seq=None) -> torch.Tensor:
    return conv(x) if seq is None else seq.conv(conv, x)


def _dense_w(linear: nn.Linear) -> torch.Tensor:
    """An ``nn.Linear`` weight as the fused ops take it: a [in, out] view."""
    return linear.weight.t()


def _conv_w(conv: nn.Conv1d) -> torch.Tensor:
    """An ``nn.Conv1d`` weight as a [k, in, out] view."""
    return conv.weight.permute(2, 1, 0)


class CrossAttention(nn.Module):
    """SDPA attention: q from x, k/v from ``context`` (or x); additive key
    bias [B, 1, S] (unet1d.py:34). With ``use_flash`` (off by default, as
    in JAX) a call that passes the flash gate (unet1d.py:70-74) goes through
    ``ops.flash_attention.sdpa``: K8 on the card, its plain version on the
    CPU. With a ``tp`` group (``parallel.sharding``: ``to_q`` / ``to_k`` /
    ``to_v`` hold the rank's heads, ``to_out`` their input features) the
    module computes ``heads / tp.size`` heads and sums ``to_out`` over the
    group. Self-attention with a ``seq`` level runs the ring over the
    ``seq`` ranks (the key bias is this rank's keys')."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.use_flash = False
        self.tp = None
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def uses_flash(self, t: int, s: int) -> bool:
        """Whether a call with ``t`` queries and ``s`` keys takes the flash
        route."""
        return flash_ok((None, self.heads, t, self.dim_head),
                        (None, self.heads, s, self.dim_head), self.use_flash)

    def forward(self, x, context=None, attention_bias=None, seq=None):
        tp = self.tp
        if tp is not None:
            x = tp.enter(x)
            context = None if context is None else tp.enter(context)
        ctx = x if context is None else context
        b, t, _ = x.shape
        heads = self.heads if tp is None else self.heads // tp.size

        def split(a):
            return a.reshape(b, -1, heads, self.dim_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), \
            split(self.to_v(ctx))
        if seq is not None and context is None:
            out = ring_attention(q, k, v, bias_to_keep_mask(attention_bias),
                                 group=seq.group, sizes=seq.sizes,
                                 scale=self.dim_head ** -0.5)
        elif self.uses_flash(t, ctx.shape[1]):
            out = sdpa(q, k, v, bias_to_keep_mask(attention_bias),
                       sm_scale=self.dim_head ** -0.5, use_flash=True)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) \
                * self.dim_head ** -0.5
            if attention_bias is not None:
                scores = scores + attention_bias[:, None].to(scores.dtype)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, t, -1)
        return self.to_out(out) if tp is None else tp.row(self.to_out, out)


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward, mult 4, exact-erf GELU. With a ``tp`` group
    ``proj`` holds the rank's block of the value and of the gate units and
    ``out`` their input features."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.tp = None
        self.proj = nn.Linear(dim, 2 * dim * mult)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        tp = self.tp
        h, gate = self.proj(x if tp is None else tp.enter(x)).chunk(2, dim=-1)
        h = h * F.gelu(gate)
        return self.out(h) if tp is None else tp.row(self.out, h)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF (unet1d.py:135);
    with ``moe_experts`` > 0 the feed-forward is ``ff_moe``, a top-k gated
    ``MoEFeedForward`` (unet1d.py:214-219), and the block takes its plain
    route whatever ``use_fused`` says, as JAX's ``_fused_enabled`` does
    (:157-160). ``remat`` is its ``nn.remat`` policy."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None,
                 use_fused: bool = True, moe_experts: int = 0,
                 moe_top_k: int = 2):
        super().__init__()
        self.dim, self.num_heads, self.head_dim = dim, num_heads, head_dim
        self.use_fused = use_fused
        self.moe_experts = moe_experts
        self.remat = "none"
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads, head_dim)
        self.has_cross = cross_attention_dim is not None
        if self.has_cross:
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(dim, num_heads, head_dim,
                                        cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        if moe_experts:
            self.ff_moe = MoEFeedForward(dim, moe_experts, top_k=moe_top_k)
        else:
            self.ff = GEGLUFeedForward(dim)

    def _fused_enabled(self, attention_bias) -> bool:
        # the fused kernels take whole weights: none under tensor parallelism
        return (self.use_fused and not self.training
                and attention_bias is None and not self.moe_experts
                and self.num_heads * self.head_dim == self.dim
                and self.attn1.tp is None)

    def forward(self, x, context=None, attention_bias=None,
                context_bias=None, seq=None):
        return remat_call(self.remat, self._forward, x, context,
                          attention_bias, context_bias, seq=seq)

    def _forward(self, x, context, attention_bias, context_bias, seq=None):
        if self._fused_enabled(attention_bias):
            cdt = self.norm1.weight.dtype

            def attn(norm: nn.LayerNorm, a: CrossAttention):
                return (norm.weight, norm.bias, _dense_w(a.to_q),
                        _dense_w(a.to_k), _dense_w(a.to_v),
                        _dense_w(a.to_out), a.to_out.bias)
            x = fused_self_attention(x, *attn(self.norm1, self.attn1),
                                     heads=self.num_heads, compute_dtype=cdt,
                                     seq=seq)
            if self.has_cross:
                x = fused_cross_attention(
                    x, context, context_bias, *attn(self.norm2, self.attn2),
                    heads=self.num_heads, compute_dtype=cdt)
            return fused_geglu_ff(
                x, self.norm3.weight, self.norm3.bias,
                _dense_w(self.ff.proj), self.ff.proj.bias,
                _dense_w(self.ff.out), self.ff.out.bias, compute_dtype=cdt)
        x = x + self.attn1(self.norm1(x), None, attention_bias, seq)
        if self.has_cross:
            x = x + self.attn2(self.norm2(x), context, context_bias)
        ff = self.ff_moe if self.moe_experts else self.ff
        return x + ff(self.norm3(x))


class Transformer1D(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in -> blocks -> proj_out + residual."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int,
                 num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, moe_experts: int = 0,
                 moe_top_k: int = 2):
        super().__init__()
        inner = num_heads * head_dim
        self.num_layers = num_layers
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        for i in range(num_layers):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, num_heads, head_dim,
                cross_attention_dim=cross_attention_dim,
                moe_experts=moe_experts, moe_top_k=moe_top_k))
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context=None, attention_bias=None,
                context_bias=None, seq=None):
        h = self.proj_in(_group_norm(self.norm, x, seq))
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, context, attention_bias,
                                            context_bias, seq)
        return self.proj_out(h) + x


def _mish(x):
    return x * torch.tanh(F.softplus(x))


class AdaLayerNorm(nn.Module):
    """LayerNorm without affine, modulated by an embedded timestep
    (unet1d.py:225): emb -> SiLU -> Linear(2C) -> x * (1 + scale) + shift.
    A scalar timestep gives one scale / shift; a batch [B] one an item,
    broadcast over time."""

    def __init__(self, embedding_dim: int, num_embeddings: int):
        super().__init__()
        self.emb = nn.Embedding(num_embeddings, embedding_dim)
        self.linear = nn.Linear(embedding_dim, 2 * embedding_dim)
        self.norm = nn.LayerNorm(embedding_dim, eps=1e-5,
                                 elementwise_affine=False)

    def forward(self, x, timestep):
        scale, shift = self.linear(F.silu(self.emb(timestep))).chunk(2, -1)
        if scale.ndim == 2:
            scale, shift = scale[:, None], shift[:, None]
        return self.norm(x) * (1 + scale) + shift


# AdaGroupNorm's activations (unet1d.py:266-267: flax's nn.gelu is the
# tanh approximation)
_ADA_ACT = {"silu": F.silu, "swish": F.silu, "mish": _mish,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}


class AdaGroupNorm(nn.Module):
    """GroupNorm without affine, modulated by a conditioning embedding
    (unet1d.py:250): [act ->] Linear(2 out_dim) -> x * (1 + scale) + shift,
    one scale / shift an item."""

    def __init__(self, embedding_dim: int, out_dim: int, num_groups: int,
                 act_fn: Optional[str] = None, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps, self.act_fn = num_groups, eps, act_fn
        self.linear = nn.Linear(embedding_dim, 2 * out_dim)

    def forward(self, x, emb):
        if self.act_fn is not None:
            emb = _ADA_ACT[self.act_fn](emb)
        scale, shift = self.linear(emb).chunk(2, -1)
        h = F.group_norm(x.transpose(1, 2), self.num_groups,
                         eps=self.eps).transpose(1, 2)
        return h * (1 + scale[:, None]) + shift[:, None]


class SpatialNorm(nn.Module):
    """GroupNorm (32 groups, eps 1e-6, affine) of f modulated by a latent
    zq nearest-resized to f's length (unet1d.py:280): norm(f) *
    conv_y(zq) + conv_b(zq), the 1x1 convs as Linear."""

    def __init__(self, f_channels: int, zq_channels: int):
        super().__init__()
        self.norm_layer = nn.GroupNorm(32, f_channels, eps=1e-6)
        self.conv_y = nn.Linear(zq_channels, f_channels)
        self.conv_b = nn.Linear(zq_channels, f_channels)

    def forward(self, f, zq):
        """f [B, T, C_f], zq [B, S, C_zq]."""
        t, s = f.shape[1], zq.shape[1]
        zq = zq[:, (torch.arange(t, device=f.device) * s) // t]
        return _group_norm(self.norm_layer, f) * self.conv_y(zq) \
            + self.conv_b(zq)


class DualTransformer1D(nn.Module):
    """Two ``Transformer1D``s over the two parts of a context split at
    ``condition_lengths`` (unet1d.py:337): condition i goes through
    transformer ``transformer_index_for_condition[i]``, and the two
    residual deltas are mixed by ``mix_ratio``. Each transformer takes its
    fused route as ``Transformer1D`` does (K2-K4 on the card)."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int,
                 num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32, mix_ratio: float = 0.5,
                 condition_lengths: Sequence[int] = (77, 257),
                 transformer_index_for_condition: Sequence[int] = (1, 0)):
        super().__init__()
        self.mix_ratio = mix_ratio
        self.condition_lengths = tuple(condition_lengths)
        self.index = tuple(transformer_index_for_condition)
        # only the transformers a condition uses hold parameters, as in
        # the flax tree
        for i in sorted(set(self.index)):
            self.add_module(f"transformer_{i}", Transformer1D(
                in_channels, num_heads, head_dim, num_layers,
                cross_attention_dim, norm_num_groups))

    def forward(self, x, context):
        deltas, start = [], 0
        for i in range(2):
            # contiguous: K3 takes the context as a dense [B, S, C]
            cond = context[:, start:start + self.condition_lengths[i]]
            enc = getattr(self, f"transformer_{self.index[i]}")(
                x, cond.contiguous())
            deltas.append(enc - x)
            start += self.condition_lengths[i]
        return (deltas[0] * self.mix_ratio
                + deltas[1] * (1.0 - self.mix_ratio)) + x


class ResnetBlock1D(nn.Module):
    """GN -> SiLU -> conv, FiLM (scale_shift) after GN2, SiLU -> conv,
    + 1x1 or identity shortcut (unet1d.py:376). ``remat`` is its
    ``nn.remat`` policy."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, groups: int = 32, eps: float = 1e-5,
                 use_fused: bool = True):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.groups, self.eps, self.use_fused = groups, eps, use_fused
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv1d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, 2 * out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv1d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Linear(in_channels, out_channels)
                              if in_channels != out_channels else None)
        self.remat = "none"

    def _fused_enabled(self) -> bool:
        return (self.use_fused and not self.training
                and self.in_channels % self.groups == 0
                and self.out_channels % self.groups == 0)

    def forward(self, x, temb, seq=None):
        return remat_call(self.remat, self._forward, x, temb, seq=seq)

    def _forward(self, x, temb, seq=None):
        if self._fused_enabled():
            # film = silu(temb) @ wt + bt in float32, outside the kernel
            # (unet1d.py:426)
            film = F.linear(F.silu(temb.float()),
                            self.time_emb_proj.weight.float(),
                            self.time_emb_proj.bias.float())
            sc = self.conv_shortcut
            return fused_resnet_block(
                x, film, self.norm1.weight, self.norm1.bias,
                _conv_w(self.conv1), self.conv1.bias, self.norm2.weight,
                self.norm2.bias, _conv_w(self.conv2), self.conv2.bias,
                None if sc is None else _dense_w(sc),
                None if sc is None else sc.bias, groups=self.groups,
                eps=self.eps, compute_dtype=self.conv1.weight.dtype, seq=seq)
        h = _conv(self.conv1, F.silu(_group_norm(self.norm1, x, seq)), seq)
        scale, shift = self.time_emb_proj(F.silu(temb))[:, None].chunk(
            2, dim=-1)
        h = _group_norm(self.norm2, h, seq) * (1 + scale) + shift
        h = _conv(self.conv2, F.silu(h), seq)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample1D(nn.Module):
    """k3 stride-2 conv, padding 1 (unet1d.py:465)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x, seq=None):
        return _conv(self.conv, x, seq)


class Upsample1D(nn.Module):
    """Nearest upsample to ``output_size`` (default 2T) + k3 conv
    (unet1d.py:479)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1d(channels, out_channels, 3, padding=1)

    def forward(self, x, output_size: Optional[int] = None, seq=None):
        if seq is not None:     # output_size: the whole skip's length
            return seq.up().conv(self.conv, seq.upsample(x, output_size))
        t = x.shape[1]
        if output_size is None or output_size == 2 * t:
            x = torch.repeat_interleave(x, 2, dim=1)
        else:
            idx = (torch.arange(output_size, device=x.device) * t) \
                // output_size
            x = x[:, idx]
        return self.conv(x)


class CrossAttnDownBlock1D(nn.Module):
    """(Resnet -> Transformer) x N + optional downsample."""

    def __init__(self, in_channels, out_channels, temb_channels,
                 num_layers=2, num_heads=8, cross_attention_dim=128,
                 groups=8, add_downsample=True, **moe):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            in_ch = in_channels if i == 0 else out_channels
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                in_ch, out_channels, temb_channels, groups=groups))
            self.add_module(f"attn_{i}", Transformer1D(
                out_channels, num_heads, out_channels // num_heads,
                cross_attention_dim=cross_attention_dim,
                norm_num_groups=groups, **moe))
        self.downsample = (Downsample1D(out_channels, out_channels)
                           if add_downsample else None)

    def forward(self, x, temb, context, context_bias=None,
                attention_bias=None, seq=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb, seq)
            x = getattr(self, f"attn_{i}")(x, context, attention_bias,
                                           context_bias, seq)
            outputs.append(x)
        if self.downsample is not None:
            x = self.downsample(x, seq)
            outputs.append(x)
        return x, outputs


class DownBlock1D(nn.Module):
    """Resnet x N + optional downsample."""

    def __init__(self, in_channels, out_channels, temb_channels,
                 num_layers=2, groups=8, add_downsample=True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            in_ch = in_channels if i == 0 else out_channels
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                in_ch, out_channels, temb_channels, groups=groups))
        self.downsample = (Downsample1D(out_channels, out_channels)
                           if add_downsample else None)

    def forward(self, x, temb, seq=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb, seq)
            outputs.append(x)
        if self.downsample is not None:
            x = self.downsample(x, seq)
            outputs.append(x)
        return x, outputs


class MidBlock1DCrossAttn(nn.Module):
    """Resnet + (Transformer + Resnet) x N."""

    def __init__(self, in_channels, temb_channels, num_layers=1,
                 num_heads=8, cross_attention_dim=128, groups=8, **moe):
        super().__init__()
        self.num_layers = num_layers
        self.resnet_0 = ResnetBlock1D(in_channels, in_channels,
                                      temb_channels, groups=groups)
        for i in range(num_layers):
            self.add_module(f"attn_{i}", Transformer1D(
                in_channels, num_heads, in_channels // num_heads,
                cross_attention_dim=cross_attention_dim,
                norm_num_groups=groups, **moe))
            self.add_module(f"resnet_{i + 1}", ResnetBlock1D(
                in_channels, in_channels, temb_channels, groups=groups))

    def forward(self, x, temb, context, context_bias=None,
                attention_bias=None, seq=None):
        x = self.resnet_0(x, temb, seq)
        for i in range(self.num_layers):
            x = getattr(self, f"attn_{i}")(x, context, attention_bias,
                                           context_bias, seq)
            x = getattr(self, f"resnet_{i + 1}")(x, temb, seq)
        return x


def _up_resnet_channels(in_channels, out_channels, prev_output_channel,
                        num_layers, i):
    res_skip = in_channels if i == num_layers - 1 else out_channels
    resnet_in = prev_output_channel if i == 0 else out_channels
    return resnet_in + res_skip


class CrossAttnUpBlock1D(nn.Module):
    """(concat skip -> Resnet -> Transformer) x N + optional upsample."""

    def __init__(self, in_channels, out_channels, prev_output_channel,
                 temb_channels, num_layers=3, num_heads=8,
                 cross_attention_dim=128, groups=8, add_upsample=True,
                 **moe):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                _up_resnet_channels(in_channels, out_channels,
                                    prev_output_channel, num_layers, i),
                out_channels, temb_channels, groups=groups))
            self.add_module(f"attn_{i}", Transformer1D(
                out_channels, num_heads, out_channels // num_heads,
                cross_attention_dim=cross_attention_dim,
                norm_num_groups=groups, **moe))
        self.upsample = (Upsample1D(out_channels, out_channels)
                         if add_upsample else None)

    def forward(self, x, res_stack: List[torch.Tensor], temb, context,
                context_bias=None, attention_bias=None, upsample_size=None,
                seq=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb, seq)
            x = getattr(self, f"attn_{i}")(x, context, attention_bias,
                                           context_bias, seq)
        if self.upsample is not None:
            x = self.upsample(x, upsample_size, seq)
        return x


class UpBlock1D(nn.Module):
    """(concat skip -> Resnet) x N + optional upsample."""

    def __init__(self, in_channels, out_channels, prev_output_channel,
                 temb_channels, num_layers=3, groups=8, add_upsample=True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                _up_resnet_channels(in_channels, out_channels,
                                    prev_output_channel, num_layers, i),
                out_channels, temb_channels, groups=groups))
        self.upsample = (Upsample1D(out_channels, out_channels)
                         if add_upsample else None)

    def forward(self, x, res_stack: List[torch.Tensor], temb,
                upsample_size=None, seq=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb, seq)
        if self.upsample is not None:
            x = self.upsample(x, upsample_size, seq)
        return x


class UNet1DConditionModel(nn.Module):
    """The conditional UNet (unet1d.py:676): down = CrossAttn x 3 + Down,
    mid = CrossAttn, up = Up + CrossAttn x 3, scale_shift resnets, 'text'
    additive embedding by attention pooling over the cross-attention keys.

    ``in_channels`` is the width of ``sample`` (flax infers conv_in's input
    width from the data; the port needs it up front). ``moe_experts`` > 0
    gives every transformer block a ``moe_top_k``-gated MoE feed-forward
    (unet1d.py:696-697).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 384, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 8,
                 cross_attention_dim: int = 128, attention_head_dim: int = 8,
                 addition_embed_type: Optional[str] = "text",
                 addition_embed_type_num_heads: int = 64,
                 flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = tuple(block_out_channels)
        n = len(ch)
        heads, groups = attention_head_dim, norm_num_groups
        moe = dict(moe_experts=moe_experts, moe_top_k=moe_top_k)
        temb = ch[0] * 4
        self.block_out_channels = ch
        self.layers_per_block = layers_per_block
        self.addition_embed_type = addition_embed_type
        self.time_proj = Timesteps(ch[0], flip_sin_to_cos, freq_shift)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        if addition_embed_type == "text":
            # clamp pooling heads so dim_per_head >= 1 on small configs
            self.add_embedding = TextTimeEmbedding(
                cross_attention_dim, temb,
                num_heads=min(addition_embed_type_num_heads,
                              cross_attention_dim))
        elif addition_embed_type is not None:
            raise NotImplementedError(
                f"addition_embed_type {addition_embed_type!r}")
        self.conv_in = Conv1d(in_channels, ch[0], 3, padding=1)
        for i in range(n):
            in_ch = ch[max(i - 1, 0)]
            if i < n - 1:
                blk = CrossAttnDownBlock1D(
                    in_ch, ch[i], temb, num_layers=layers_per_block,
                    num_heads=heads, cross_attention_dim=cross_attention_dim,
                    groups=groups, add_downsample=True, **moe)
            else:
                blk = DownBlock1D(in_ch, ch[i], temb,
                                  num_layers=layers_per_block, groups=groups,
                                  add_downsample=False)
            self.add_module(f"down_{i}", blk)
        self.mid = MidBlock1DCrossAttn(
            ch[-1], temb, num_heads=heads,
            cross_attention_dim=cross_attention_dim, groups=groups, **moe)
        rev = list(reversed(ch))
        prev_out = rev[0]
        for i in range(n):
            out_ch, in_ch = rev[i], rev[min(i + 1, n - 1)]
            final = i == n - 1
            if i == 0:
                blk = UpBlock1D(in_ch, out_ch, prev_out, temb,
                                num_layers=layers_per_block + 1,
                                groups=groups, add_upsample=not final)
            else:
                blk = CrossAttnUpBlock1D(
                    in_ch, out_ch, prev_out, temb,
                    num_layers=layers_per_block + 1, num_heads=heads,
                    cross_attention_dim=cross_attention_dim, groups=groups,
                    add_upsample=not final, **moe)
            self.add_module(f"up_{i}", blk)
            prev_out = out_ch
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv1d(ch[0], out_channels, 3, padding=1)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, sample, timestep, encoder_hidden_states,
                encoder_attention_mask=None, attention_mask=None, *,
                emb=None, embedding_request=None):
        """sample [B, T, C_in]; timestep scalar or [B]; encoder_hidden_states
        [B, S, cross_attention_dim]; masks [B, S] / [B, T] keep (1) or None;
        ``emb`` an injected [B, 4*ch0] time+text embedding;
        ``embedding_request`` 'time' or 'text' returns only that part.
        Inside a sequence-parallel scope (module docstring) ``sample`` and
        ``attention_mask`` are whole and the result is this rank's frames
        [B, T_rank, C_out]."""
        dtype = self.conv_in.weight.dtype
        dev = self.conv_in.weight.device
        if encoder_hidden_states is not None:
            encoder_hidden_states = encoder_hidden_states.to(dtype)
        if embedding_request == "text":
            return self.add_embedding(encoder_hidden_states)
        if emb is None or embedding_request == "time":
            timesteps = torch.atleast_1d(torch.as_tensor(timestep,
                                                         device=dev))
            if embedding_request != "time" and \
                    timesteps.shape[0] != sample.shape[0]:
                timesteps = timesteps.expand(sample.shape[0])
            emb = self.time_embedding(self.time_proj(timesteps).to(dtype))
            if embedding_request == "time":
                return emb
            if self.addition_embed_type == "text":
                emb = emb + self.add_embedding(encoder_hidden_states)
        else:
            emb = emb.to(dtype)

        def to_bias(m):
            if m is None:
                return None
            return ((1 - m.float()) * -10000.0)[:, None, :].contiguous()

        n = len(self.block_out_channels)
        # sequence parallelism: this rank's frames, at every level
        top = activations.shard(sample.shape[1], n)
        seq = [None] * n if top is None else [top.plan.level(i)
                                              for i in range(n)]
        if top is not None:
            sample = top.cut(sample)
            if attention_mask is not None:
                attention_mask = top.cut(attention_mask)

        attn_bias = to_bias(attention_mask)
        ctx_bias = to_bias(encoder_attention_mask)
        ctx = encoder_hidden_states

        sample = _conv(self.conv_in, sample.to(dtype), seq[0])
        res_stack = [sample]
        for i in range(n):
            blk = getattr(self, f"down_{i}")
            if i < n - 1:
                sample, outs = blk(sample, emb, ctx, ctx_bias, attn_bias,
                                   seq=seq[i])
            else:
                sample, outs = blk(sample, emb, seq=seq[i])
            res_stack.extend(outs)
        sample = self.mid(sample, emb, ctx, ctx_bias, attn_bias,
                          seq=seq[n - 1])
        n_res = self.layers_per_block + 1
        for i in range(n):
            # force the upsample size to the next skip's (whole) length
            upsample_size = (None if i == n - 1
                             else res_stack[-(n_res + 1)].shape[1]
                             if top is None else seq[n - 2 - i].length)
            blk = getattr(self, f"up_{i}")
            if i == 0:
                sample = blk(sample, res_stack, emb, upsample_size,
                             seq=seq[n - 1])
            else:
                sample = blk(sample, res_stack, emb, ctx, ctx_bias,
                             attn_bias, upsample_size, seq=seq[n - 1 - i])
        sample = F.silu(_group_norm(self.conv_norm_out, sample, seq[0]))
        return _conv(self.conv_out, sample, seq[0])


def set_use_fused(module: nn.Module, flag: bool) -> None:
    """Route every kernel-backed module under ``module`` (the UNet's
    resnet and transformer blocks, the rel-pos attention of the VITS
    encoders, the spline couplings) through its kernels (True) or its plain
    formulation (False)."""
    for m in module.modules():
        if hasattr(m, "use_fused"):
            m.use_fused = flag


def set_use_flash(module: nn.Module, flag: bool) -> None:
    """Route the score/softmax/PV core of every attention module under
    ``module`` that has a flash route (the UNet's ``CrossAttention``, the
    prompt encoders' ``EncSALayer``) through K8 (True) or its plain
    formulation (False, the default, as in JAX). ``set_use_fused`` leaves
    this flag alone."""
    for m in module.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = flag
