"""The UNet1D block zoo and the ``get_down_block`` / ``get_up_block``
factories, channel-last [B, T, C].

Port of ``diff_vits_tpu/nn/unet1d_blocks.py``: the FIR, K, pooling and
nearest resamplers, the deprecated-attn-block attention
(``LegacyAttention1D``), the added-KV attention, the full-option resnet,
the mid / down / up blocks of every family (Attn, Skip, Encoder /
Decoder, ResnetResample, SimpleCrossAttn, K) and the factories. The
factories' ``DownBlock``, ``UpBlock`` and ``CrossAttn*Block`` types are the
model's own blocks of ``nn/unet1d.py``, so they take the kernel routes of
``ResnetBlock1D`` (K1) and ``BasicTransformerBlock`` (K2-K4) there; every
other block is plain PyTorch on either device. Submodules carry the flax
names (``resnet_0``, ``attn_1``, ``downsample``, ``skip_conv``, ...).

The JAX module's 1-D semantics hold where it departs from the reference's
4-D code (:14-36): attention runs over time with channel features, the
in-block pool is a 1-D average over T, the FIR and K resamplers are their
1-D forms, ``KAttentionBlock1D`` works on [B, T, C] directly, and the Skip
blocks' image channels are ``skip_channels``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.layers import Conv1d, dropout
from diff_vits_tpu_torch.nn.unet1d import (
    AdaGroupNorm, CrossAttnDownBlock1D, CrossAttnUpBlock1D, DownBlock1D,
    Downsample1D, SpatialNorm, UpBlock1D, Upsample1D, _group_norm)

_ACT = {"swish": F.silu, "silu": F.silu, "gelu": F.gelu,
        "mish": lambda x: x * torch.tanh(F.softplus(x)), "relu": torch.relu}


# ---------------------------------------------------------------------------
# Resamplers: FIR (upfirdn), K (reflect-pad binomial), plain pool / nearest

def _depthwise(x: torch.Tensor, kernel, stride: int = 1) -> torch.Tensor:
    """Correlate each channel of x [B, T, C] with ``kernel`` (VALID)."""
    c = x.shape[-1]
    w = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    w = w.to(x.dtype)[None, None].expand(c, 1, -1)
    return F.conv1d(x.transpose(1, 2), w, stride=stride,
                    groups=c).transpose(1, 2)


def _zero_stuff(x: torch.Tensor, up: int) -> torch.Tensor:
    """[B, T, C] -> [B, T * up, C] with x at every ``up``-th frame."""
    b, t, c = x.shape
    return F.pad(x[:, :, None], (0, 0, 0, up - 1)).reshape(b, t * up, c)


def upfirdn1d(x, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """1-D upfirdn on [B, T, C]: zero-stuff by ``up``, pad (a negative pad
    crops), correlate with ``kernel`` per channel, keep every ``down``-th
    frame."""
    if up > 1:
        x = _zero_stuff(x, up)
    p0, p1 = pad
    x = F.pad(x, (0, 0, max(p0, 0), max(p1, 0)))
    if p0 < 0:
        x = x[:, -p0:]
    if p1 < 0:
        x = x[:, :p1]
    y = _depthwise(x, kernel)
    return y[:, ::down] if down > 1 else y


def fir_downsample_1d(x, kernel: Sequence[float] = (1, 3, 3, 1),
                      factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR anti-aliased downsample by ``factor``."""
    k = np.asarray(kernel, np.float32)
    k = k / k.sum() * gain
    p = len(k) - factor
    return upfirdn1d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def fir_upsample_1d(x, kernel: Sequence[float] = (1, 3, 3, 1),
                    factor: int = 2, gain: float = 1.0) -> torch.Tensor:
    """FIR interpolating upsample by ``factor``: factor * T frames."""
    k = np.asarray(kernel, np.float32)
    k = k / k.sum() * (gain * factor)
    p = len(k) - factor
    return upfirdn1d(x, k, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def avg_pool_1d(x, factor: int = 2) -> torch.Tensor:
    """Average over ``factor`` frames (floor: a last partial window is
    dropped)."""
    b, t, c = x.shape
    t2 = (t // factor) * factor
    return x[:, :t2].reshape(b, t // factor, factor, c).mean(dim=2)


def nearest_upsample_1d(x, factor: int = 2) -> torch.Tensor:
    return torch.repeat_interleave(x, factor, dim=1)


def _reflect1(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad one frame on each side of [B, T, C]."""
    return F.pad(x.transpose(1, 2), (1, 1), mode="reflect").transpose(1, 2)


def k_downsample_1d(x) -> torch.Tensor:
    """K-diffusion downsample: reflect-pad 1, correlate with [1,3,3,1]/8,
    stride 2."""
    return _depthwise(_reflect1(x), np.array([1, 3, 3, 1], np.float32) / 8,
                      stride=2)


def k_upsample_1d(x) -> torch.Tensor:
    """K-diffusion upsample: reflect-pad 1, then the stride-2 transpose conv
    with 2 * [1,3,3,1]/8 and padding 3, as zero-stuffing by 2 and a VALID
    correlation (the kernel is symmetric): 2 * T frames."""
    x = _zero_stuff(_reflect1(x), 2)[:, :-1]
    return _depthwise(x, np.array([1, 3, 3, 1], np.float32) / 4)


class FirUpsample1D(nn.Module):
    """FIR upsample, then a k3 conv ``Conv1d_0`` with ``use_conv``."""

    def __init__(self, channels: Optional[int] = None,
                 out_channels: Optional[int] = None, use_conv: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)
        self.Conv1d_0 = (Conv1d(channels, out_channels or channels, 3,
                                padding=1) if use_conv else None)

    def forward(self, x):
        y = fir_upsample_1d(x, self.fir_kernel)
        return y if self.Conv1d_0 is None else self.Conv1d_0(y)


class FirDownsample1D(nn.Module):
    """FIR downsample, then a k3 conv ``Conv1d_0`` with ``use_conv``."""

    def __init__(self, channels: Optional[int] = None,
                 out_channels: Optional[int] = None, use_conv: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        self.fir_kernel = tuple(fir_kernel)
        self.Conv1d_0 = (Conv1d(channels, out_channels or channels, 3,
                                padding=1) if use_conv else None)

    def forward(self, x):
        y = fir_downsample_1d(x, self.fir_kernel)
        return y if self.Conv1d_0 is None else self.Conv1d_0(y)


class KDownsample1D(nn.Module):
    def forward(self, x):
        return k_downsample_1d(x)


class KUpsample1D(nn.Module):
    def forward(self, x):
        return k_upsample_1d(x)


# ---------------------------------------------------------------------------
# Attention variants

def _heads_attention(q, k, v, heads: int, dim_head: int, bias=None):
    """softmax(q k^T / sqrt(d) + bias) v in float32 probabilities, per
    head; q [B, T, H*D], k/v [B, S, H*D], bias [B, 1, S] additive."""
    b, t, _ = q.shape

    def split(z):
        return z.reshape(b, -1, heads, dim_head).transpose(1, 2)

    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) \
        * dim_head ** -0.5
    if bias is not None:
        scores = scores + bias[:, None].to(scores.dtype)
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.matmul(p, split(v)).transpose(1, 2).reshape(
        b, t, heads * dim_head)


class LegacyAttention1D(nn.Module):
    """The deprecated-attn-block attention (unet1d_blocks.py:208): optional
    input GroupNorm or SpatialNorm, q/k/v/out projections (q/k/v biased with
    ``use_bias``), float32 softmax, dropout, residual, output rescale.
    x [B, T, C]; context [B, S, D] or None; ``attention_bias`` additive
    [B, 1, S]."""

    def __init__(self, channels: int, num_heads: int, dim_head: int,
                 norm_num_groups: Optional[int] = None,
                 spatial_norm_dim: Optional[int] = None,
                 cross_attention_dim: Optional[int] = None,
                 cross_attention_norm: Optional[str] = None,
                 use_bias: bool = True, residual_connection: bool = True,
                 rescale_output_factor: float = 1.0, eps: float = 1e-5,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dim_head = num_heads, dim_head
        self.residual_connection = residual_connection
        self.rescale_output_factor, self.p_dropout = (rescale_output_factor,
                                                      dropout)
        self.spatial_norm = (SpatialNorm(channels, spatial_norm_dim)
                             if spatial_norm_dim is not None else None)
        self.group_norm = (nn.GroupNorm(norm_num_groups, channels, eps=eps)
                           if spatial_norm_dim is None
                           and norm_num_groups is not None else None)
        ctx_dim = cross_attention_dim or channels
        self.norm_cross = (nn.LayerNorm(ctx_dim, eps=1e-5)
                           if cross_attention_norm == "layer_norm"
                           and cross_attention_dim is not None else None)
        inner = num_heads * dim_head
        self.to_q = nn.Linear(channels, inner, bias=use_bias)
        self.to_k = nn.Linear(ctx_dim, inner, bias=use_bias)
        self.to_v = nn.Linear(ctx_dim, inner, bias=use_bias)
        self.to_out = nn.Linear(inner, channels)

    def forward(self, x, context=None, temb=None, attention_bias=None, *,
                generator: Optional[torch.Generator] = None):
        residual, h = x, x
        if self.spatial_norm is not None:
            h = self.spatial_norm(h, temb)
        elif self.group_norm is not None:
            h = _group_norm(self.group_norm, h)
        ctx = h if context is None else context
        if context is not None and self.norm_cross is not None:
            ctx = self.norm_cross(ctx)
        out = _heads_attention(self.to_q(h), self.to_k(ctx), self.to_v(ctx),
                               self.num_heads, self.dim_head, attention_bias)
        out = dropout(self.to_out(out), self.p_dropout, self.training,
                      generator)
        if self.residual_connection:
            out = out + residual
        return out / self.rescale_output_factor


class AddedKVAttention1D(nn.Module):
    """Attention with added key / value projections of a prompt
    (unet1d_blocks.py:278): GroupNorm on x, q from it, keys and values the
    projected prompt followed by x's own (only the prompt's with
    ``only_cross_attention``), residual. ``context_bias`` [B, 1, S] covers
    the prompt keys; x's keys get 0."""

    def __init__(self, query_dim: int, num_heads: int, dim_head: int,
                 added_kv_proj_dim: int,
                 norm_num_groups: Optional[int] = 32,
                 only_cross_attention: bool = False,
                 cross_attention_norm: Optional[str] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.num_heads, self.dim_head = num_heads, dim_head
        inner = num_heads * dim_head
        self.group_norm = (nn.GroupNorm(norm_num_groups, query_dim, eps=eps)
                           if norm_num_groups is not None else None)
        self.norm_cross = (nn.LayerNorm(added_kv_proj_dim, eps=1e-5)
                           if cross_attention_norm == "layer_norm" else None)
        self.to_q = nn.Linear(query_dim, inner)
        self.add_k_proj = nn.Linear(added_kv_proj_dim, inner)
        self.add_v_proj = nn.Linear(added_kv_proj_dim, inner)
        if not only_cross_attention:
            self.to_k = nn.Linear(query_dim, inner)
            self.to_v = nn.Linear(query_dim, inner)
        self.only_cross_attention = only_cross_attention
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context, context_bias=None):
        h = x if self.group_norm is None else _group_norm(self.group_norm, x)
        ctx = context if self.norm_cross is None else self.norm_cross(context)
        k, v = self.add_k_proj(ctx), self.add_v_proj(ctx)
        if not self.only_cross_attention:
            k = torch.cat([k, self.to_k(h)], dim=1)
            v = torch.cat([v, self.to_v(h)], dim=1)
        bias = context_bias
        if bias is not None and k.shape[1] > bias.shape[-1]:
            bias = F.pad(bias, (0, k.shape[1] - bias.shape[-1]))
        out = _heads_attention(self.to_q(h), k, v, self.num_heads,
                               self.dim_head, bias)
        return self.to_out(out) + x


# ---------------------------------------------------------------------------
# Full-option resnet

class ResnetBlockFull(nn.Module):
    """The resnet with every option (unet1d_blocks.py:353):
    ``time_embedding_norm`` default (temb added before norm2), scale_shift,
    ada_group (both norms ``AdaGroupNorm``) or spatial (``SpatialNorm``);
    in-block ``resample`` "up" / "down" of x and h after norm1 (FIR with
    ``resample_kernel="fir"``, else nearest / average pooling); separate
    ``groups_out``; ``skip_time_act``; ``output_scale_factor``; a forced
    (``use_in_shortcut``) or bias-free shortcut; a distinct last conv width
    ``conv_out_channels``."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 conv_out_channels: Optional[int] = None,
                 temb_channels: Optional[int] = 512, groups: int = 32,
                 groups_out: Optional[int] = None, eps: float = 1e-6,
                 non_linearity: str = "swish", skip_time_act: bool = False,
                 time_embedding_norm: str = "default",
                 resample: Optional[str] = None,
                 resample_kernel: Optional[str] = None,
                 output_scale_factor: float = 1.0,
                 use_in_shortcut: Optional[bool] = None,
                 conv_shortcut_bias: bool = True, dropout: float = 0.0):
        super().__init__()
        out_ch = out_channels or in_channels
        conv_out = conv_out_channels or out_ch
        groups_out = groups_out or groups
        self.act = _ACT[non_linearity]
        self.skip_time_act, self.norm_kind = skip_time_act, time_embedding_norm
        self.resample, self.resample_kernel = resample, resample_kernel
        self.output_scale_factor, self.p_dropout = output_scale_factor, dropout
        ada = time_embedding_norm == "ada_group"
        spatial = time_embedding_norm == "spatial"

        def norm(ch, g):
            if ada:
                return AdaGroupNorm(temb_channels, ch, g, eps=eps)
            if spatial:
                return SpatialNorm(ch, temb_channels)
            return nn.GroupNorm(g, ch, eps=eps)
        self.norm1 = norm(in_channels, groups)
        self.conv1 = Conv1d(in_channels, out_ch, 3, padding=1)
        self.time_emb_proj = None
        if temb_channels is not None and not (ada or spatial):
            width = 2 * out_ch if time_embedding_norm == "scale_shift" \
                else out_ch
            self.time_emb_proj = nn.Linear(temb_channels, width)
        self.norm2 = norm(out_ch, groups_out)
        self.conv2 = Conv1d(out_ch, conv_out, 3, padding=1)
        use_short = (in_channels != conv_out if use_in_shortcut is None
                     else use_in_shortcut)
        self.conv_shortcut = (nn.Linear(in_channels, conv_out,
                                        bias=conv_shortcut_bias)
                              if use_short else None)

    def _resample(self, x):
        fir = self.resample_kernel == "fir"
        if self.resample == "up":
            return fir_upsample_1d(x) if fir else nearest_upsample_1d(x)
        if self.resample == "down":
            return fir_downsample_1d(x) if fir else avg_pool_1d(x)
        return x

    def _norm(self, norm, h, temb):
        if isinstance(norm, (AdaGroupNorm, SpatialNorm)):
            return norm(h, temb)
        return _group_norm(norm, h)

    def forward(self, x, temb=None, *,
                generator: Optional[torch.Generator] = None):
        h = self.act(self._norm(self.norm1, x, temb))
        if self.resample is not None:
            x, h = self._resample(x), self._resample(h)
        h = self.conv1(h)
        temb_proj = None
        if self.time_emb_proj is not None:
            t = temb if self.skip_time_act else self.act(temb)
            temb_proj = self.time_emb_proj(t)[:, None]
        if temb_proj is not None and self.norm_kind == "default":
            h = h + temb_proj
        h = self._norm(self.norm2, h, temb)
        if temb_proj is not None and self.norm_kind == "scale_shift":
            scale, shift = temb_proj.chunk(2, dim=-1)
            h = h * (1 + scale) + shift
        h = dropout(self.act(h), self.p_dropout, self.training, generator)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return (x + h) / self.output_scale_factor


def _resnet(in_ch, out_ch, temb_channels, groups, eps, time_scale_shift,
            output_scale_factor, **kw) -> ResnetBlockFull:
    return ResnetBlockFull(in_ch, out_ch, temb_channels=temb_channels,
                           groups=groups, eps=eps,
                           time_embedding_norm=time_scale_shift,
                           output_scale_factor=output_scale_factor, **kw)


def _up_in(in_channels, out_channels, prev_output_channel, num_layers, i):
    """A skip-concatenating up block's resnet i input width."""
    res_skip = in_channels if i == num_layers - 1 else out_channels
    return (prev_output_channel if i == 0 else out_channels) + res_skip


# ---------------------------------------------------------------------------
# Mid blocks

class MidBlock1D(nn.Module):
    """resnet -> [self-attention -> resnet] x N (unet1d_blocks.py:464); the
    "spatial" variant conditions its attentions with ``SpatialNorm``."""

    def __init__(self, in_channels: int, temb_channels: Optional[int] = 512,
                 num_layers: int = 1, groups: int = 32, eps: float = 1e-6,
                 time_scale_shift: str = "default",
                 add_attention: bool = True,
                 attention_head_dim: Optional[int] = 1,
                 output_scale_factor: float = 1.0, dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.add_attention = num_layers, add_attention
        head_dim = attention_head_dim or in_channels
        spatial = time_scale_shift == "spatial"
        for i in range(num_layers + 1):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels, in_channels, temb_channels, groups, eps,
                time_scale_shift, output_scale_factor, dropout=dropout))
        for i in range(num_layers if add_attention else 0):
            self.add_module(f"attn_{i}", LegacyAttention1D(
                in_channels, in_channels // head_dim, head_dim,
                norm_num_groups=None if spatial else groups,
                spatial_norm_dim=temb_channels if spatial else None,
                rescale_output_factor=output_scale_factor, eps=eps))

    def forward(self, x, temb=None, *,
                generator: Optional[torch.Generator] = None):
        x = self.resnet_0(x, temb, generator=generator)
        for i in range(self.num_layers):
            if self.add_attention:
                x = getattr(self, f"attn_{i}")(x, temb=temb)
            x = getattr(self, f"resnet_{i + 1}")(x, temb, generator=generator)
        return x


class MidBlock1DSimpleCrossAttn(nn.Module):
    """resnet -> [added-KV attention -> resnet] x N
    (unet1d_blocks.py:506)."""

    def __init__(self, in_channels: int, temb_channels: int,
                 cross_attention_dim: int = 1280, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: int = 1,
                 time_scale_shift: str = "default",
                 skip_time_act: bool = False,
                 only_cross_attention: bool = False,
                 cross_attention_norm: Optional[str] = None,
                 output_scale_factor: float = 1.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers + 1):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels, in_channels, temb_channels, groups, eps,
                time_scale_shift, output_scale_factor,
                skip_time_act=skip_time_act))
        for i in range(num_layers):
            self.add_module(f"attn_{i}", AddedKVAttention1D(
                in_channels, in_channels // attention_head_dim,
                attention_head_dim, added_kv_proj_dim=cross_attention_dim,
                norm_num_groups=groups,
                only_cross_attention=only_cross_attention,
                cross_attention_norm=cross_attention_norm))

    def forward(self, x, temb=None, context=None, context_bias=None):
        x = self.resnet_0(x, temb)
        for i in range(self.num_layers):
            x = getattr(self, f"attn_{i}")(
                x, context if context is not None else x, context_bias)
            x = getattr(self, f"resnet_{i + 1}")(x, temb)
        return x


# ---------------------------------------------------------------------------
# Down blocks

class AttnDownBlock1D(nn.Module):
    """(resnet -> self-attention) x N, then a conv or resnet downsample
    (unet1d_blocks.py:555)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = 1.0,
                 downsample_type: Optional[str] = "conv"):
        super().__init__()
        self.num_layers = num_layers
        head_dim = attention_head_dim or out_channels
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, groups, eps, time_scale_shift,
                output_scale_factor))
            self.add_module(f"attn_{i}", LegacyAttention1D(
                out_channels, out_channels // head_dim, head_dim,
                norm_num_groups=groups,
                rescale_output_factor=output_scale_factor, eps=eps))
        self.downsample = None
        if downsample_type == "conv":
            self.downsample = Downsample1D(out_channels, out_channels)
        elif downsample_type == "resnet":
            self.downsample = _resnet(
                out_channels, out_channels, temb_channels, groups, eps,
                time_scale_shift, output_scale_factor, resample="down")

    def forward(self, x, temb=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            x = getattr(self, f"attn_{i}")(x)
            outputs.append(x)
        if isinstance(self.downsample, ResnetBlockFull):
            x = self.downsample(x, temb)
            outputs.append(x)
        elif self.downsample is not None:
            x = self.downsample(x)
            outputs.append(x)
        return x, outputs


class DownEncoderBlock1D(nn.Module):
    """temb-free resnets + conv downsample (unet1d_blocks.py:606)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 1, groups: int = 32, eps: float = 1e-6,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = 1.0,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels, None,
                groups, eps, time_scale_shift, output_scale_factor))
        self.downsample = (Downsample1D(out_channels, out_channels)
                           if add_downsample else None)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, None)
        return x if self.downsample is None else self.downsample(x)


class AttnDownEncoderBlock1D(nn.Module):
    """(temb-free resnet -> self-attention) x N + conv downsample
    (unet1d_blocks.py:636)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 1, groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = 1.0,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        head_dim = attention_head_dim or out_channels
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels, None,
                groups, eps, time_scale_shift, output_scale_factor))
            self.add_module(f"attn_{i}", LegacyAttention1D(
                out_channels, out_channels // head_dim, head_dim,
                norm_num_groups=groups,
                rescale_output_factor=output_scale_factor, eps=eps))
        self.downsample = (Downsample1D(out_channels, out_channels)
                           if add_downsample else None)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"attn_{i}")(
                getattr(self, f"resnet_{i}")(x, None))
        return x if self.downsample is None else self.downsample(x)


class SkipDownBlock1D(nn.Module):
    """NCSN++-style block (unet1d_blocks.py:673): resnets, then a FIR
    down-resampling resnet whose output takes the FIR-downsampled skip
    stream through ``skip_conv``. With ``attention`` (AttnSkipDownBlock1D)
    each resnet is followed by a 32-group self-attention."""

    attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 eps: float = 1e-6, attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = math.sqrt(2.0),
                 add_downsample: bool = True, skip_channels: int = 3):
        super().__init__()
        self.num_layers = num_layers
        head_dim = attention_head_dim or out_channels
        g_out = min(out_channels // 4, 32)
        for i in range(num_layers):
            in_ch = in_channels if i == 0 else out_channels
            self.add_module(f"resnet_{i}", _resnet(
                in_ch, out_channels, temb_channels, min(in_ch // 4, 32), eps,
                time_scale_shift, output_scale_factor, groups_out=g_out))
            if self.attention:
                self.add_module(f"attn_{i}", LegacyAttention1D(
                    out_channels, out_channels // head_dim, head_dim,
                    norm_num_groups=32,
                    rescale_output_factor=output_scale_factor, eps=eps))
        self.add_downsample = add_downsample
        if add_downsample:
            self.resnet_down = _resnet(
                out_channels, out_channels, temb_channels, g_out, eps,
                time_scale_shift, output_scale_factor, use_in_shortcut=True,
                resample="down", resample_kernel="fir")
            self.downsample = FirDownsample1D()
            self.skip_conv = nn.Linear(skip_channels, out_channels)

    def forward(self, x, temb=None, skip_sample=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x)
            outputs.append(x)
        if self.add_downsample:
            x = self.resnet_down(x, temb)
            skip_sample = self.downsample(skip_sample)
            x = self.skip_conv(skip_sample) + x
            outputs.append(x)
        return x, outputs, skip_sample


class AttnSkipDownBlock1D(SkipDownBlock1D):
    """SkipDownBlock1D with a self-attention after each resnet
    (unet1d_blocks.py:720)."""

    attention = True


class ResnetDownsampleBlock1D(nn.Module):
    """resnets + a down-resampling resnet (unet1d_blocks.py:774)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 time_scale_shift: str = "default",
                 skip_time_act: bool = False,
                 output_scale_factor: float = 1.0,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(skip_time_act=skip_time_act)
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, groups, eps, time_scale_shift,
                output_scale_factor, **kw))
        self.downsample = (_resnet(
            out_channels, out_channels, temb_channels, groups, eps,
            time_scale_shift, output_scale_factor, resample="down", **kw)
            if add_downsample else None)

    def forward(self, x, temb=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            outputs.append(x)
        if self.downsample is not None:
            x = self.downsample(x, temb)
            outputs.append(x)
        return x, outputs


class SimpleCrossAttnDownBlock1D(nn.Module):
    """(resnet -> added-KV attention) x N + a down-resampling resnet
    (unet1d_blocks.py:816)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, cross_attention_dim: int = 1280,
                 num_layers: int = 1, groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: int = 1,
                 time_scale_shift: str = "default",
                 skip_time_act: bool = False,
                 only_cross_attention: bool = False,
                 cross_attention_norm: Optional[str] = None,
                 output_scale_factor: float = 1.0,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(skip_time_act=skip_time_act)
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, groups, eps, time_scale_shift,
                output_scale_factor, **kw))
            self.add_module(f"attn_{i}", AddedKVAttention1D(
                out_channels, out_channels // attention_head_dim,
                attention_head_dim, added_kv_proj_dim=cross_attention_dim,
                norm_num_groups=groups,
                only_cross_attention=only_cross_attention,
                cross_attention_norm=cross_attention_norm))
        self.downsample = (_resnet(
            out_channels, out_channels, temb_channels, groups, eps,
            time_scale_shift, output_scale_factor, resample="down", **kw)
            if add_downsample else None)

    def forward(self, x, temb=None, context=None, context_bias=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            x = getattr(self, f"attn_{i}")(
                x, context if context is not None else x, context_bias)
            outputs.append(x)
        if self.downsample is not None:
            x = self.downsample(x, temb)
            outputs.append(x)
        return x, outputs


def _k_resnet(in_ch, out_ch, temb_channels, group_size, eps,
              **kw) -> ResnetBlockFull:
    """The K blocks' resnet: ada_group norms, GELU, bias-free shortcut."""
    return ResnetBlockFull(
        in_ch, out_ch, temb_channels=temb_channels,
        groups=in_ch // group_size, groups_out=out_ch // group_size,
        eps=eps, non_linearity="gelu", time_embedding_norm="ada_group",
        conv_shortcut_bias=False, **kw)


class KDownBlock1D(nn.Module):
    """ada_group resnets + K downsample (unet1d_blocks.py:874)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 4,
                 resnet_group_size: int = 32, eps: float = 1e-5,
                 add_downsample: bool = False):
        super().__init__()
        self.num_layers, self.add_downsample = num_layers, add_downsample
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _k_resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, resnet_group_size, eps))

    def forward(self, x, temb=None):
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            outputs.append(x)
        if self.add_downsample:
            x = k_downsample_1d(x)
        return x, outputs


class KAttentionBlock1D(nn.Module):
    """AdaGroupNorm-conditioned [self-attention ->] cross-attention, both
    residual, no feed-forward (unet1d_blocks.py:951), on [B, T, C]."""

    def __init__(self, dim: int, num_heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 temb_channels: int = 768, add_self_attention: bool = False,
                 attention_bias: bool = True,
                 cross_attention_norm: Optional[str] = "layer_norm",
                 group_size: int = 32, dropout: float = 0.0):
        super().__init__()
        groups = max(1, dim // group_size)
        self.add_self_attention = add_self_attention
        if add_self_attention:
            self.norm1 = AdaGroupNorm(temb_channels, dim, groups)
            self.attn1 = LegacyAttention1D(
                dim, num_heads, dim_head, use_bias=attention_bias,
                residual_connection=False, dropout=dropout)
        self.norm2 = AdaGroupNorm(temb_channels, dim, groups)
        self.attn2 = LegacyAttention1D(
            dim, num_heads, dim_head, use_bias=attention_bias,
            cross_attention_dim=cross_attention_dim,
            cross_attention_norm=cross_attention_norm,
            residual_connection=False, dropout=dropout)

    def forward(self, x, context=None, temb=None, context_bias=None,
                attention_bias=None, *,
                generator: Optional[torch.Generator] = None):
        if self.add_self_attention:
            x = self.attn1(self.norm1(x, temb), attention_bias=attention_bias,
                           generator=generator) + x
        h = self.attn2(self.norm2(x, temb), context=context,
                       attention_bias=context_bias if context is not None
                       else attention_bias, generator=generator)
        return h + x


class KCrossAttnDownBlock1D(nn.Module):
    """ada_group resnets + K attention blocks + K downsample
    (unet1d_blocks.py:905); a layer's skip output is None without the
    downsampler, as in the reference."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, cross_attention_dim: int,
                 num_layers: int = 4, resnet_group_size: int = 32,
                 attention_head_dim: int = 64,
                 add_self_attention: bool = False, eps: float = 1e-5,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers, self.add_downsample = num_layers, add_downsample
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _k_resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, resnet_group_size, eps))
            self.add_module(f"attn_{i}", KAttentionBlock1D(
                out_channels, out_channels // attention_head_dim,
                attention_head_dim, cross_attention_dim=cross_attention_dim,
                temb_channels=temb_channels,
                add_self_attention=add_self_attention,
                group_size=resnet_group_size))

    def forward(self, x, temb=None, context=None, context_bias=None):
        outputs: List[Optional[torch.Tensor]] = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            x = getattr(self, f"attn_{i}")(x, context, temb, context_bias)
            outputs.append(x if self.add_downsample else None)
        if self.add_downsample:
            x = k_downsample_1d(x)
        return x, outputs


# ---------------------------------------------------------------------------
# Up blocks

class AttnUpBlock1D(nn.Module):
    """(concat skip -> resnet -> self-attention) x N + conv or resnet
    upsample (unet1d_blocks.py:1005)."""

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = 1.0,
                 upsample_type: Optional[str] = "conv"):
        super().__init__()
        self.num_layers = num_layers
        head_dim = attention_head_dim or out_channels
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                _up_in(in_channels, out_channels, prev_output_channel,
                       num_layers, i), out_channels, temb_channels, groups,
                eps, time_scale_shift, output_scale_factor))
            self.add_module(f"attn_{i}", LegacyAttention1D(
                out_channels, out_channels // head_dim, head_dim,
                norm_num_groups=groups,
                rescale_output_factor=output_scale_factor, eps=eps))
        self.upsample = None
        if upsample_type == "conv":
            self.upsample = Upsample1D(out_channels, out_channels)
        elif upsample_type == "resnet":
            self.upsample = _resnet(
                out_channels, out_channels, temb_channels, groups, eps,
                time_scale_shift, output_scale_factor, resample="up")

    def forward(self, x, res_stack: List[torch.Tensor], temb=None,
                upsample_size=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"attn_{i}")(
                getattr(self, f"resnet_{i}")(x, temb))
        if isinstance(self.upsample, ResnetBlockFull):
            x = self.upsample(x, temb)
        elif self.upsample is not None:
            x = self.upsample(x, upsample_size)
        return x


class UpDecoderBlock1D(nn.Module):
    """resnets + conv upsample (unet1d_blocks.py:1058); with ``attention``
    (AttnUpDecoderBlock1D) a self-attention after each resnet, conditioned
    by ``SpatialNorm`` in the "spatial" variant."""

    attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = 1.0,
                 add_upsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        head_dim = attention_head_dim or out_channels
        spatial = time_scale_shift == "spatial"
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, groups, eps, time_scale_shift,
                output_scale_factor))
            if self.attention:
                self.add_module(f"attn_{i}", LegacyAttention1D(
                    out_channels, out_channels // head_dim, head_dim,
                    norm_num_groups=None if spatial else groups,
                    spatial_norm_dim=temb_channels if spatial else None,
                    rescale_output_factor=output_scale_factor, eps=eps))
        self.upsample = (Upsample1D(out_channels, out_channels)
                         if add_upsample else None)

    def forward(self, x, temb=None):
        for i in range(self.num_layers):
            x = getattr(self, f"resnet_{i}")(x, temb)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x, temb=temb)
        return x if self.upsample is None else self.upsample(x)


class AttnUpDecoderBlock1D(UpDecoderBlock1D):
    """UpDecoderBlock1D with a self-attention after each resnet
    (unet1d_blocks.py:1088)."""

    attention = True


class SkipUpBlock1D(nn.Module):
    """NCSN++-style up block (unet1d_blocks.py:1128): skip-concatenating
    resnets; the skip stream FIR-upsampled and, with ``add_upsample``, added
    to skip_conv(SiLU(skip_norm(x))) before a FIR up-resampling resnet.
    With ``attention`` (AttnSkipUpBlock1D) one 32-group self-attention
    ``attn_0`` follows the resnets, and the resnets' groups take the
    reference's min(in + skip // 4, 32) (unet1d_blocks.py:1212-1219)."""

    attention = False

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 eps: float = 1e-6, attention_head_dim: Optional[int] = 1,
                 time_scale_shift: str = "default",
                 output_scale_factor: float = math.sqrt(2.0),
                 add_upsample: bool = True, skip_channels: int = 3):
        super().__init__()
        self.num_layers, self.add_upsample = num_layers, add_upsample
        g_out = min(out_channels // 4, 32)
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            resnet_in = prev_output_channel if i == 0 else out_channels
            groups = (min(resnet_in + res_skip // 4, 32) if self.attention
                      else min((resnet_in + res_skip) // 4, 32))
            self.add_module(f"resnet_{i}", _resnet(
                resnet_in + res_skip, out_channels, temb_channels, groups,
                eps, time_scale_shift, output_scale_factor,
                groups_out=g_out))
        if self.attention:
            head_dim = attention_head_dim or out_channels
            self.attn_0 = LegacyAttention1D(
                out_channels, out_channels // head_dim, head_dim,
                norm_num_groups=32,
                rescale_output_factor=output_scale_factor, eps=eps)
        if add_upsample:
            self.skip_norm = nn.GroupNorm(g_out, out_channels, eps=eps)
            self.skip_conv = Conv1d(out_channels, skip_channels, 3,
                                    padding=1)
            self.resnet_up = _resnet(
                out_channels, out_channels, temb_channels, g_out, eps,
                time_scale_shift, output_scale_factor, groups_out=g_out,
                use_in_shortcut=True, resample="up", resample_kernel="fir")

    def forward(self, x, res_stack: List[torch.Tensor], temb=None,
                skip_sample=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb)
        if self.attention:
            x = self.attn_0(x)
        skip_sample = (fir_upsample_1d(skip_sample)
                       if skip_sample is not None else 0.0)
        if self.add_upsample:
            h = self.skip_conv(F.silu(_group_norm(self.skip_norm, x)))
            skip_sample = skip_sample + h
            x = self.resnet_up(x, temb)
        return x, skip_sample


class AttnSkipUpBlock1D(SkipUpBlock1D):
    """SkipUpBlock1D with one self-attention after the resnets
    (unet1d_blocks.py:1185)."""

    attention = True


class ResnetUpsampleBlock1D(nn.Module):
    """skip-concatenating resnets + an up-resampling resnet
    (unet1d_blocks.py:1256)."""

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int,
                 temb_channels: Optional[int] = 512, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 time_scale_shift: str = "default",
                 skip_time_act: bool = False,
                 output_scale_factor: float = 1.0,
                 add_upsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(skip_time_act=skip_time_act)
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                _up_in(in_channels, out_channels, prev_output_channel,
                       num_layers, i), out_channels, temb_channels, groups,
                eps, time_scale_shift, output_scale_factor, **kw))
        self.upsample = (_resnet(
            out_channels, out_channels, temb_channels, groups, eps,
            time_scale_shift, output_scale_factor, resample="up", **kw)
            if add_upsample else None)

    def forward(self, x, res_stack: List[torch.Tensor], temb=None,
                upsample_size=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb)
        return x if self.upsample is None else self.upsample(x, temb)


class SimpleCrossAttnUpBlock1D(nn.Module):
    """(concat skip -> resnet -> added-KV attention) x N + an
    up-resampling resnet (unet1d_blocks.py:1300)."""

    def __init__(self, in_channels: int, out_channels: int,
                 prev_output_channel: int, temb_channels: int,
                 cross_attention_dim: int = 1280, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-6,
                 attention_head_dim: int = 1,
                 time_scale_shift: str = "default",
                 skip_time_act: bool = False,
                 only_cross_attention: bool = False,
                 cross_attention_norm: Optional[str] = None,
                 output_scale_factor: float = 1.0,
                 add_upsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(skip_time_act=skip_time_act)
        for i in range(num_layers):
            self.add_module(f"resnet_{i}", _resnet(
                _up_in(in_channels, out_channels, prev_output_channel,
                       num_layers, i), out_channels, temb_channels, groups,
                eps, time_scale_shift, output_scale_factor, **kw))
            self.add_module(f"attn_{i}", AddedKVAttention1D(
                out_channels, out_channels // attention_head_dim,
                attention_head_dim, added_kv_proj_dim=cross_attention_dim,
                norm_num_groups=groups,
                only_cross_attention=only_cross_attention,
                cross_attention_norm=cross_attention_norm))
        self.upsample = (_resnet(
            out_channels, out_channels, temb_channels, groups, eps,
            time_scale_shift, output_scale_factor, resample="up", **kw)
            if add_upsample else None)

    def forward(self, x, res_stack: List[torch.Tensor], temb=None,
                context=None, context_bias=None, upsample_size=None):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = getattr(self, f"resnet_{i}")(x, temb)
            x = getattr(self, f"attn_{i}")(
                x, context if context is not None else x, context_bias)
        return x if self.upsample is None else self.upsample(x, temb)


class KUpBlock1D(nn.Module):
    """concat the single deepest skip, ada_group resnets (2 out -> out ->
    ... -> in), K upsample (unet1d_blocks.py:1360)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 5,
                 resnet_group_size: int = 32, eps: float = 1e-5,
                 add_upsample: bool = True):
        super().__init__()
        self.n, self.add_upsample = num_layers - 1, add_upsample
        for i in range(self.n):
            in_ch = 2 * out_channels if i == 0 else out_channels
            out_ch = in_channels if i == self.n - 1 else out_channels
            self.add_module(f"resnet_{i}", ResnetBlockFull(
                in_ch, out_ch, temb_channels=temb_channels,
                groups=in_ch // resnet_group_size,
                groups_out=out_channels // resnet_group_size, eps=eps,
                non_linearity="gelu", time_embedding_norm="ada_group",
                conv_shortcut_bias=False))

    def forward(self, x, res, temb=None, upsample_size=None):
        if res is not None:
            x = torch.cat([x, res], dim=-1)
        for i in range(self.n):
            x = getattr(self, f"resnet_{i}")(x, temb)
        return k_upsample_1d(x) if self.add_upsample else x


class KCrossAttnUpBlock1D(nn.Module):
    """ada_group resnets + K attention blocks + K upsample, with the
    k-unet's channel rules (unet1d_blocks.py:1396): the first block (in ==
    out == temb) adds self-attention and takes no skip width, a middle
    block (in != out) ends in a conv of width ``in_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, cross_attention_dim: int = 768,
                 num_layers: int = 4, resnet_group_size: int = 32,
                 attention_head_dim: int = 1, eps: float = 1e-5,
                 add_upsample: bool = True):
        super().__init__()
        is_first = in_channels == out_channels == temb_channels
        is_middle = in_channels != out_channels
        k_in = out_channels if is_first else 2 * out_channels
        self.n, self.add_upsample = num_layers - 1, add_upsample
        for i in range(self.n):
            in_ch = k_in if i == 0 else out_channels
            last = i == self.n - 1
            attn_dim = in_channels if last else out_channels
            self.add_module(f"resnet_{i}", ResnetBlockFull(
                in_ch, out_channels,
                conv_out_channels=in_channels if is_middle and last
                else None,
                temb_channels=temb_channels,
                groups=in_ch // resnet_group_size,
                groups_out=out_channels // resnet_group_size, eps=eps,
                non_linearity="gelu", time_embedding_norm="ada_group",
                conv_shortcut_bias=False))
            self.add_module(f"attn_{i}", KAttentionBlock1D(
                attn_dim, attn_dim // attention_head_dim, attention_head_dim,
                cross_attention_dim=cross_attention_dim,
                temb_channels=temb_channels, add_self_attention=is_first,
                group_size=resnet_group_size))

    def forward(self, x, res, temb=None, context=None, context_bias=None,
                upsample_size=None):
        if res is not None:
            x = torch.cat([x, res], dim=-1)
        for i in range(self.n):
            x = getattr(self, f"resnet_{i}")(x, temb)
            x = getattr(self, f"attn_{i}")(x, context, temb, context_bias)
        return k_upsample_1d(x) if self.add_upsample else x


# ---------------------------------------------------------------------------
# Factories (unet1d_blocks.py:1453-1689)

def _canon(block_type: str) -> str:
    """A type name without the ``UNetRes`` prefix, in the '2D' spelling
    (the reference's names; '1D' names are accepted too)."""
    if block_type.startswith("UNetRes"):
        block_type = block_type[7:]
    return block_type.replace("1D", "2D")


def get_down_block(
        down_block_type, num_layers, in_channels, out_channels,
        temb_channels, add_downsample, resnet_eps=1e-6,
        resnet_act_fn="swish", transformer_layers_per_block=1,
        num_attention_heads=None, resnet_groups=None,
        cross_attention_dim=None, downsample_padding=None,
        dual_cross_attention=False, use_linear_projection=False,
        only_cross_attention=False, upcast_attention=False,
        resnet_time_scale_shift="default", resnet_skip_time_act=False,
        resnet_out_scale_factor=1.0, cross_attention_norm=None,
        attention_head_dim=None, downsample_type=None) -> nn.Module:
    """A down block by type name (unet1d_blocks.py:1460); forward
    signatures vary by family as in the JAX package. Unknown names raise
    ``ValueError``."""
    if attention_head_dim is None:
        attention_head_dim = num_attention_heads
    t = _canon(down_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    if t == "DownBlock2D":
        return DownBlock1D(in_channels, out_channels, temb_channels,
                           num_layers=num_layers, groups=groups,
                           add_downsample=add_downsample)
    if t == "ResnetDownsampleBlock2D":
        return ResnetDownsampleBlock1D(
            in_channels, out_channels, temb_channels=temb_channels,
            num_layers=num_layers, groups=groups, eps=resnet_eps,
            time_scale_shift=resnet_time_scale_shift,
            skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor,
            add_downsample=add_downsample)
    if t == "AttnDownBlock2D":
        downsample_type = (None if add_downsample is False
                           else downsample_type or "conv")
        return AttnDownBlock1D(
            in_channels, out_channels, temb_channels=temb_channels,
            num_layers=num_layers, groups=groups, eps=resnet_eps,
            attention_head_dim=attention_head_dim,
            time_scale_shift=resnet_time_scale_shift,
            downsample_type=downsample_type)
    if t in ("CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D") \
            and cross_attention_dim is None:
        raise ValueError(f"cross_attention_dim must be specified for {t}")
    if t == "CrossAttnDownBlock2D":
        return CrossAttnDownBlock1D(
            in_channels, out_channels, temb_channels, num_layers=num_layers,
            num_heads=num_attention_heads,
            cross_attention_dim=cross_attention_dim, groups=groups,
            add_downsample=add_downsample)
    if t == "SimpleCrossAttnDownBlock2D":
        return SimpleCrossAttnDownBlock1D(
            in_channels, out_channels, temb_channels=temb_channels,
            cross_attention_dim=cross_attention_dim, num_layers=num_layers,
            groups=groups, eps=resnet_eps,
            attention_head_dim=attention_head_dim,
            time_scale_shift=resnet_time_scale_shift,
            skip_time_act=resnet_skip_time_act,
            only_cross_attention=only_cross_attention,
            cross_attention_norm=cross_attention_norm,
            output_scale_factor=resnet_out_scale_factor,
            add_downsample=add_downsample)
    if t in ("SkipDownBlock2D", "AttnSkipDownBlock2D"):
        cls = SkipDownBlock1D if t == "SkipDownBlock2D" \
            else AttnSkipDownBlock1D
        return cls(in_channels, out_channels, temb_channels=temb_channels,
                   num_layers=num_layers, eps=resnet_eps,
                   attention_head_dim=attention_head_dim,
                   time_scale_shift=resnet_time_scale_shift,
                   add_downsample=add_downsample)
    if t == "DownEncoderBlock2D":
        return DownEncoderBlock1D(
            in_channels, out_channels, num_layers=num_layers, groups=groups,
            eps=resnet_eps, time_scale_shift=resnet_time_scale_shift,
            add_downsample=add_downsample)
    if t == "AttnDownEncoderBlock2D":
        return AttnDownEncoderBlock1D(
            in_channels, out_channels, num_layers=num_layers, groups=groups,
            eps=resnet_eps, attention_head_dim=attention_head_dim,
            time_scale_shift=resnet_time_scale_shift,
            add_downsample=add_downsample)
    if t == "KDownBlock2D":
        return KDownBlock1D(in_channels, out_channels, temb_channels,
                            num_layers=num_layers, eps=resnet_eps,
                            add_downsample=add_downsample)
    if t == "KCrossAttnDownBlock2D":
        return KCrossAttnDownBlock1D(
            in_channels, out_channels, temb_channels,
            cross_attention_dim=cross_attention_dim, num_layers=num_layers,
            attention_head_dim=attention_head_dim or 64, eps=resnet_eps,
            add_self_attention=not add_downsample,
            add_downsample=add_downsample)
    raise ValueError(f"{down_block_type} does not exist.")


def get_up_block(
        up_block_type, num_layers, in_channels, out_channels,
        prev_output_channel, temb_channels, add_upsample, resnet_eps=1e-6,
        resnet_act_fn="swish", transformer_layers_per_block=1,
        num_attention_heads=None, resnet_groups=None,
        cross_attention_dim=None, dual_cross_attention=False,
        use_linear_projection=False, only_cross_attention=False,
        upcast_attention=False, resnet_time_scale_shift="default",
        resnet_skip_time_act=False, resnet_out_scale_factor=1.0,
        cross_attention_norm=None, attention_head_dim=None,
        upsample_type=None) -> nn.Module:
    """An up block by type name (unet1d_blocks.py:1573). Unknown names
    raise ``ValueError``."""
    if attention_head_dim is None:
        attention_head_dim = num_attention_heads
    t = _canon(up_block_type)
    groups = resnet_groups if resnet_groups is not None else 32
    if t == "UpBlock2D":
        return UpBlock1D(in_channels, out_channels, prev_output_channel,
                         temb_channels, num_layers=num_layers, groups=groups,
                         add_upsample=add_upsample)
    if t == "ResnetUpsampleBlock2D":
        return ResnetUpsampleBlock1D(
            in_channels, out_channels, prev_output_channel,
            temb_channels=temb_channels, num_layers=num_layers,
            groups=groups, eps=resnet_eps,
            time_scale_shift=resnet_time_scale_shift,
            skip_time_act=resnet_skip_time_act,
            output_scale_factor=resnet_out_scale_factor,
            add_upsample=add_upsample)
    if t in ("CrossAttnUpBlock2D", "SimpleCrossAttnUpBlock2D") \
            and cross_attention_dim is None:
        raise ValueError(f"cross_attention_dim must be specified for {t}")
    if t == "CrossAttnUpBlock2D":
        return CrossAttnUpBlock1D(
            in_channels, out_channels, prev_output_channel, temb_channels,
            num_layers=num_layers, num_heads=num_attention_heads,
            cross_attention_dim=cross_attention_dim, groups=groups,
            add_upsample=add_upsample)
    if t == "SimpleCrossAttnUpBlock2D":
        return SimpleCrossAttnUpBlock1D(
            in_channels, out_channels, prev_output_channel,
            temb_channels=temb_channels,
            cross_attention_dim=cross_attention_dim, num_layers=num_layers,
            groups=groups, eps=resnet_eps,
            attention_head_dim=attention_head_dim,
            time_scale_shift=resnet_time_scale_shift,
            skip_time_act=resnet_skip_time_act,
            only_cross_attention=only_cross_attention,
            cross_attention_norm=cross_attention_norm,
            output_scale_factor=resnet_out_scale_factor,
            add_upsample=add_upsample)
    if t == "AttnUpBlock2D":
        upsample_type = (None if add_upsample is False
                         else upsample_type or "conv")
        return AttnUpBlock1D(
            in_channels, out_channels, prev_output_channel,
            temb_channels=temb_channels, num_layers=num_layers,
            groups=groups, eps=resnet_eps,
            attention_head_dim=attention_head_dim,
            time_scale_shift=resnet_time_scale_shift,
            upsample_type=upsample_type)
    if t in ("SkipUpBlock2D", "AttnSkipUpBlock2D"):
        cls = SkipUpBlock1D if t == "SkipUpBlock2D" else AttnSkipUpBlock1D
        return cls(in_channels, out_channels, prev_output_channel,
                   temb_channels=temb_channels, num_layers=num_layers,
                   eps=resnet_eps, attention_head_dim=attention_head_dim,
                   time_scale_shift=resnet_time_scale_shift,
                   add_upsample=add_upsample)
    if t in ("UpDecoderBlock2D", "AttnUpDecoderBlock2D"):
        cls = UpDecoderBlock1D if t == "UpDecoderBlock2D" \
            else AttnUpDecoderBlock1D
        return cls(in_channels, out_channels, temb_channels=temb_channels,
                   num_layers=num_layers, groups=groups, eps=resnet_eps,
                   attention_head_dim=attention_head_dim,
                   time_scale_shift=resnet_time_scale_shift,
                   add_upsample=add_upsample)
    if t == "KUpBlock2D":
        return KUpBlock1D(in_channels, out_channels, temb_channels,
                          num_layers=num_layers, eps=resnet_eps,
                          add_upsample=add_upsample)
    if t == "KCrossAttnUpBlock2D":
        return KCrossAttnUpBlock1D(
            in_channels, out_channels, temb_channels,
            cross_attention_dim=cross_attention_dim, num_layers=num_layers,
            attention_head_dim=attention_head_dim or 1, eps=resnet_eps,
            add_upsample=add_upsample)
    raise ValueError(f"{up_block_type} does not exist.")
