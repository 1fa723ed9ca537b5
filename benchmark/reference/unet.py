"""The conditional 1-d UNet of the reference (the diffusion denoiser and
the UNet duration predictor): down = CrossAttn x 3 + Down, mid =
CrossAttn, up = Up + CrossAttn x 3, scale-shift resnets, a 'text'
additive embedding by attention pooling over the cross-attention keys.
Copied from the port's plain route; channel-last [B, T, C]."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    Conv1d, TextTimeEmbedding, TimestepEmbedding, timestep_embedding)


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.transpose(1, 2)).transpose(1, 2)


class CrossAttention(nn.Module):
    """q from x, k / v from ``context`` (or x); additive key bias."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, attention_bias=None):
        ctx = x if context is None else context
        b, t, _ = x.shape

        def split(a):
            return a.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), \
            split(self.to_v(ctx))
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head ** -0.5
        if attention_bias is not None:
            scores = scores + attention_bias[:, None].to(scores.dtype)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.to_out(out.transpose(1, 2).reshape(b, t, -1))


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward, mult 4, exact-erf GELU."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim * mult)
        self.out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads, head_dim)
        self.has_cross = cross_attention_dim is not None
        if self.has_cross:
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.attn2 = CrossAttention(dim, num_heads, head_dim,
                                        cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context=None, attention_bias=None,
                context_bias=None):
        x = x + self.attn1(self.norm1(x), None, attention_bias)
        if self.has_cross:
            x = x + self.attn2(self.norm2(x), context, context_bias)
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in -> block -> proj_out + residual."""

    def __init__(self, in_channels: int, num_heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None,
                 norm_num_groups: int = 32):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.block_0 = BasicTransformerBlock(
            inner, num_heads, head_dim, cross_attention_dim)
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context=None, attention_bias=None,
                context_bias=None):
        h = self.proj_in(_group_norm(self.norm, x))
        h = self.block_0(h, context, attention_bias, context_bias)
        return self.proj_out(h) + x


class ResnetBlock1D(nn.Module):
    """GN -> SiLU -> conv, FiLM after GN2, SiLU -> conv, + shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv1d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, 2 * out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv1d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Linear(in_channels, out_channels)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(_group_norm(self.norm1, x)))
        scale, shift = self.time_emb_proj(F.silu(temb))[:, None].chunk(
            2, dim=-1)
        h = _group_norm(self.norm2, h) * (1 + scale) + shift
        h = self.conv2(F.silu(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample1D(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    """Nearest upsample to ``output_size`` (default 2T) + k3 conv."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1d(channels, out_channels, 3, padding=1)

    def forward(self, x, output_size: Optional[int] = None):
        t = x.shape[1]
        if output_size is None or output_size == 2 * t:
            x = torch.repeat_interleave(x, 2, dim=1)
        else:
            x = x[:, (torch.arange(output_size, device=x.device) * t)
                  // output_size]
        return self.conv(x)


class _Block(nn.Module):
    """``num_layers`` resnets, each followed by a transformer when
    ``heads`` is given; the up blocks concatenate a skip first."""

    def __init__(self, in_chs: Sequence[int], out_channels: int,
                 temb_channels: int, groups: int, heads: Optional[int],
                 cross_attention_dim: int):
        super().__init__()
        self.num_layers, self.has_attn = len(in_chs), heads is not None
        for i, in_ch in enumerate(in_chs):
            self.add_module(f"resnet_{i}", ResnetBlock1D(
                in_ch, out_channels, temb_channels, groups=groups))
            if self.has_attn:
                self.add_module(f"attn_{i}", Transformer1D(
                    out_channels, heads, out_channels // heads,
                    cross_attention_dim=cross_attention_dim,
                    norm_num_groups=groups))

    def layer(self, i, x, temb, context, context_bias, attention_bias):
        x = getattr(self, f"resnet_{i}")(x, temb)
        if self.has_attn:
            x = getattr(self, f"attn_{i}")(x, context, attention_bias,
                                           context_bias)
        return x


class DownBlock(_Block):
    def __init__(self, in_channels, out_channels, temb_channels, num_layers,
                 groups, heads, cross_attention_dim, add_downsample):
        super().__init__([in_channels] + [out_channels] * (num_layers - 1),
                         out_channels, temb_channels, groups, heads,
                         cross_attention_dim)
        self.downsample = (Downsample1D(out_channels, out_channels)
                           if add_downsample else None)

    def forward(self, x, temb, context, context_bias, attention_bias):
        outputs = []
        for i in range(self.num_layers):
            x = self.layer(i, x, temb, context, context_bias, attention_bias)
            outputs.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            outputs.append(x)
        return x, outputs


class UpBlock(_Block):
    def __init__(self, in_channels, out_channels, prev_output_channel,
                 temb_channels, num_layers, groups, heads,
                 cross_attention_dim, add_upsample):
        in_chs = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            resnet_in = prev_output_channel if i == 0 else out_channels
            in_chs.append(resnet_in + res_skip)
        super().__init__(in_chs, out_channels, temb_channels, groups, heads,
                         cross_attention_dim)
        self.upsample = (Upsample1D(out_channels, out_channels)
                         if add_upsample else None)

    def forward(self, x, res_stack: List[torch.Tensor], temb, context,
                context_bias, attention_bias, upsample_size):
        for i in range(self.num_layers):
            x = torch.cat([x, res_stack.pop()], dim=-1)
            x = self.layer(i, x, temb, context, context_bias, attention_bias)
        if self.upsample is not None:
            x = self.upsample(x, upsample_size)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, temb_channels, heads, cross_attention_dim,
                 groups):
        super().__init__()
        self.resnet_0 = ResnetBlock1D(channels, channels, temb_channels,
                                      groups=groups)
        self.attn_0 = Transformer1D(channels, heads, channels // heads,
                                    cross_attention_dim=cross_attention_dim,
                                    norm_num_groups=groups)
        self.resnet_1 = ResnetBlock1D(channels, channels, temb_channels,
                                      groups=groups)

    def forward(self, x, temb, context, context_bias, attention_bias):
        x = self.resnet_0(x, temb)
        x = self.attn_0(x, context, attention_bias, context_bias)
        return self.resnet_1(x, temb)


class UNet1DConditionModel(nn.Module):
    """The conditional UNet; ``in_channels`` is the width of ``sample``."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_out_channels: Sequence[int] = (128, 256, 384, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 8,
                 cross_attention_dim: int = 128, attention_head_dim: int = 8,
                 addition_embed_type_num_heads: int = 64):
        super().__init__()
        ch = tuple(block_out_channels)
        n = len(ch)
        heads, groups = attention_head_dim, norm_num_groups
        temb = ch[0] * 4
        self.block_out_channels = ch
        self.layers_per_block = layers_per_block
        self.time_channels = ch[0]
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TextTimeEmbedding(
            cross_attention_dim, temb,
            num_heads=min(addition_embed_type_num_heads, cross_attention_dim))
        self.conv_in = Conv1d(in_channels, ch[0], 3, padding=1)
        for i in range(n):
            last = i == n - 1
            self.add_module(f"down_{i}", DownBlock(
                ch[max(i - 1, 0)], ch[i], temb, layers_per_block, groups,
                None if last else heads, cross_attention_dim,
                add_downsample=not last))
        self.mid = MidBlock(ch[-1], temb, heads, cross_attention_dim, groups)
        rev = list(reversed(ch))
        prev_out = rev[0]
        for i in range(n):
            self.add_module(f"up_{i}", UpBlock(
                rev[min(i + 1, n - 1)], rev[i], prev_out, temb,
                layers_per_block + 1, groups, None if i == 0 else heads,
                cross_attention_dim, add_upsample=i != n - 1))
            prev_out = rev[i]
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv1d(ch[0], out_channels, 3, padding=1)

    def embed_time(self, timesteps):
        """Timestep-MLP embeddings [N, 4*ch0]."""
        return self.time_embedding(
            timestep_embedding(timesteps, self.time_channels))

    def forward(self, sample, timestep, context, context_keep=None, *,
                emb=None):
        """sample [B, T, C_in]; timestep scalar or [B]; context [B, S, C];
        ``context_keep`` [B, S] keep mask; ``emb`` an injected time + text
        embedding [B, 4*ch0]."""
        if emb is None:
            t = torch.atleast_1d(torch.as_tensor(timestep,
                                                 device=sample.device))
            emb = self.embed_time(t.expand(sample.shape[0]))
            emb = emb + self.add_embedding(context)
        ctx_bias = (None if context_keep is None else
                    ((1 - context_keep.float()) * -10000.0)[:, None, :])
        n = len(self.block_out_channels)
        sample = self.conv_in(sample)
        res_stack = [sample]
        for i in range(n):
            sample, outs = getattr(self, f"down_{i}")(sample, emb, context,
                                                      ctx_bias, None)
            res_stack.extend(outs)
        sample = self.mid(sample, emb, context, ctx_bias, None)
        n_res = self.layers_per_block + 1
        for i in range(n):
            size = None if i == n - 1 else res_stack[-(n_res + 1)].shape[1]
            sample = getattr(self, f"up_{i}")(sample, res_stack, emb, context,
                                              ctx_bias, None, size)
        sample = F.silu(_group_norm(self.conv_norm_out, sample))
        return self.conv_out(sample)
