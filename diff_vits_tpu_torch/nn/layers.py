"""Core layers of the port, channel-last [B, T, C].

Port of the main-path parts of ``diff_vits_tpu/nn/layers.py``: ``WN``
(:141-190), the relative-position ``MultiHeadAttention`` in its banded
form (:232-410), ``FFN`` (:413-443) and the VITS ``Encoder`` (:446-487),
with dropout where the JAX modules have it. Masks are float [B, T, 1]
(1 = keep), as in the JAX package.

Dropout is active only in ``train()`` mode, and every mask is drawn from
the ``torch.Generator`` the caller passes down (never the global stream);
flax's ``nn.Dropout`` semantics: keep with probability 1 - p, scale kept
values by 1 / (1 - p).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity in eval mode or
    at p = 0. Training with p > 0 needs a generator on x's device."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on channel-last input: [B, T, Ci] -> [B, T', Co],
    returned contiguous (the fused ops take contiguous activations).
    Parameters keep PyTorch's layout (weight [Co, Ci, k])."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.transpose(1, 2))
        return y.transpose(1, 2).contiguous()


class WN(nn.Module):
    """WaveNet core: dilated k-wide convs, gated tanh * sigmoid, res/skip
    1x1s, per-layer slices of one speaker-conditioning projection
    (layers.py:141-190). No dropout: its one user, the posterior encoder,
    keeps the JAX module's p = 0."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        self.cond_layer = (nn.Linear(gin_channels, 2 * h * n_layers)
                           if gin_channels else None)
        for i in range(n_layers):
            d = dilation_rate ** i
            # flax SAME: (k - 1) * d padding split evenly for odd k
            self.add_module(f"in_{i}", Conv1d(
                h, 2 * h, kernel_size, dilation=d,
                padding=(kernel_size - 1) * d // 2))
            self.add_module(f"res_skip_{i}", nn.Linear(
                h, 2 * h if i < n_layers - 1 else h))

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = (self.cond_layer(g) if g is not None
                 and self.cond_layer is not None else None)
        for i in range(self.n_layers):
            acts = getattr(self, f"in_{i}")(x)
            if g_all is not None:
                acts = acts + g_all[..., 2 * h * i:2 * h * (i + 1)]
            acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask


def _band_embeddings(emb: torch.Tensor, length: int, window: int):
    """The nonzero centre [g, 2w'+1, d] of the relative-position table,
    w' = min(window, length - 1) (layers.py:232-246)."""
    w_eff = min(window, length - 1)
    start = window - w_eff
    return emb[:, start:start + 2 * w_eff + 1]


def _band_to_abs(band: torch.Tensor) -> torch.Tensor:
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


def _abs_to_band(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, L, L] -> [B, H, L, 2w+1] with band[..., t, j] = x[..., t,
    t + j - w] (zero where that key is outside the sequence)."""
    l = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (2 * w + 1,))
    for j in range(2 * w + 1):
        off = j - w
        t = torch.arange(max(0, -off), min(l, l - off), device=x.device)
        out[..., t, j] = x[..., t, t + off]
    return out


class MultiHeadAttention(nn.Module):
    """Relative-position multi-head self-attention (VITS), banded form with
    a head-shared window of relative keys and values; masked scores are
    replaced by -1e4 (layers.py:389)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        self.p_dropout = p_dropout
        self.k_channels = channels // n_heads
        self.conv_q = nn.Linear(channels, channels)
        self.conv_k = nn.Linear(channels, channels)
        self.conv_v = nn.Linear(channels, channels)
        self.conv_o = nn.Linear(channels, out_channels)
        shape = (1, 2 * window_size + 1, self.k_channels)
        self.emb_rel_k = nn.Parameter(torch.zeros(shape))
        self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def forward(self, x, attn_mask=None, *,
                generator: Optional[torch.Generator] = None):
        b, t, c = x.shape
        d = self.k_channels

        def split(a):
            return a.reshape(b, t, self.n_heads, d).transpose(1, 2)

        q = split(self.conv_q(x)) / math.sqrt(d)
        k, v = split(self.conv_k(x)), split(self.conv_v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        key_band = _band_embeddings(self.emb_rel_k, t, self.window_size)
        scores = scores + _band_to_abs(
            torch.einsum("bhtd,gmd->bhtm", q, key_band.to(q.dtype)))
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p = torch.softmax(scores, dim=-1)
        p = dropout(p, self.p_dropout, self.training, generator)
        out = torch.matmul(p, v)
        w_eff = min(self.window_size, t - 1)
        value_band = _band_embeddings(self.emb_rel_v, t, self.window_size)
        out = out + torch.einsum("bhtm,gmd->bhtd", _abs_to_band(p, w_eff),
                                 value_band.to(p.dtype))
        return self.conv_o(out.transpose(1, 2).reshape(b, t, c))


class FFN(nn.Module):
    """Conv feed-forward with SAME padding and ReLU (layers.py:413)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, *,
                generator: Optional[torch.Generator] = None):
        x = self.conv_1(F.pad(x * x_mask, (0, 0) + self.pad))
        x = dropout(torch.relu(x), self.p_dropout, self.training, generator)
        x = self.conv_2(F.pad(x * x_mask, (0, 0) + self.pad))
        return x * x_mask


class Encoder(nn.Module):
    """Post-LN relative-position transformer encoder; the speaker embedding
    is added before layer ``cond_layer_idx`` (layers.py:446-487)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4,
                 gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.n_layers, self.cond_layer_idx = n_layers, cond_layer_idx
        self.p_dropout = p_dropout
        h = hidden_channels
        if gin_channels and n_layers > cond_layer_idx:
            self.spk_emb_linear = nn.Linear(gin_channels, h)
        else:
            self.spk_emb_linear = None
        for i in range(n_layers):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                h, h, n_heads, window_size=window_size, p_dropout=p_dropout))
            self.add_module(f"norm1_{i}", nn.LayerNorm(h, eps=1e-5))
            self.add_module(f"ffn_{i}", FFN(h, h, filter_channels,
                                            kernel_size, p_dropout))
            self.add_module(f"norm2_{i}", nn.LayerNorm(h, eps=1e-5))

    def forward(self, x, x_mask, g: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        m = x_mask[..., 0]
        attn_mask = (m[:, None, :, None] * m[:, None, None, :])
        x = x * x_mask
        for i in range(self.n_layers):
            if (i == self.cond_layer_idx and g is not None
                    and self.spk_emb_linear is not None):
                x = (x + self.spk_emb_linear(g)) * x_mask
            y = getattr(self, f"attn_{i}")(x, attn_mask, generator=generator)
            y = dropout(y, self.p_dropout, self.training, generator)
            x = getattr(self, f"norm1_{i}")(x + y)
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator=generator)
            y = dropout(y, self.p_dropout, self.training, generator)
            x = getattr(self, f"norm2_{i}")(x + y)
        return x * x_mask
