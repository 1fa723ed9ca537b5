"""Text prior encoder, mel posterior encoder and prompt refiner,
channel-last [B, T, C].

Port of ``TextEncoder``, ``PosteriorEncoder`` and ``PromptEncoder`` of
``diff_vits_tpu/models/encoders.py``. Dropout is active in ``train()``
mode only and draws from the ``generator`` the caller passes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.nn.fairseq import ConvLayer, EncSALayer
from diff_vits_tpu_torch.nn.layers import WN, Encoder


class TextEncoder(nn.Module):
    """phoneme + tone + language embeddings -> rel-pos transformer ->
    (x, m, logs, x_mask)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0,
                 gin_channels: int = 0, num_tones: int = 11,
                 num_languages: int = 3, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.emb = nn.Embedding(n_vocab, h)
        self.tone_emb = nn.Embedding(num_tones, h)
        self.language_emb = nn.Embedding(num_languages, h)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers,
                               kernel_size, p_dropout,
                               gin_channels=gin_channels)
        self.proj = nn.Linear(h, 2 * out_channels)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x, x_lengths, tone, language, g=None, *,
                generator: Optional[torch.Generator] = None):
        xh = (self.emb(x) + self.tone_emb(tone) + self.language_emb(language)
              ) * math.sqrt(self.hidden_channels)
        x_mask = masking.sequence_mask(x_lengths, xh.shape[1]).to(
            xh.dtype)[..., None]
        xh = self.encoder(xh * x_mask, x_mask, g=g, generator=generator)
        m, logs = (self.proj(xh) * x_mask).chunk(2, dim=-1)
        return xh, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """mel -> 1x1 -> WN -> (m, logs) -> z = (m + noise * exp(logs)) * mask,
    the noise from ``generator``; without one, z = m * mask."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = nn.Linear(hidden_channels, 2 * out_channels)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x, x_lengths, g=None, *,
                generator: Optional[torch.Generator] = None):
        x_mask = masking.sequence_mask(x_lengths, x.shape[1]).to(
            x.dtype)[..., None]
        h = self.pre(x) * x_mask
        h = self.enc(h, x_mask, g=g)
        m, logs = (self.proj(h) * x_mask).chunk(2, dim=-1)
        if generator is None:
            z = m * x_mask
        else:
            noise = torch.randn(m.shape, generator=generator,
                                device=m.device).to(m.dtype)
            z = (m + noise * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask


class PromptEncoder(nn.Module):
    """pre conv -> N x EncSALayer -> out conv (+ LN), masked."""

    def __init__(self, in_channels: int = 128, hidden_channels: int = 512,
                 out_channels: int = 128, n_layers: int = 6,
                 p_dropout: float = 0.2, last_ln: bool = True,
                 gin_channels: Optional[int] = None, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.g_proj = (nn.Linear(gin_channels, in_channels)
                       if gin_channels is not None else None)
        self.pre = ConvLayer(in_channels, hidden_channels, 1)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncSALayer(
                hidden_channels, 8, 9, p_dropout=p_dropout))
        self.out_proj = ConvLayer(hidden_channels, out_channels, 1)
        self.layer_norm = (nn.LayerNorm(out_channels, eps=1e-5)
                           if last_ln else None)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x, lengths, g=None, *,
                generator: Optional[torch.Generator] = None):
        if g is not None and self.g_proj is not None:
            x = x + self.g_proj(g)
        keep = masking.sequence_mask(lengths, x.shape[1]).to(x.dtype)[..., None]
        x = self.pre(x, keep) * keep
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, keep, generator=generator)
        x = self.out_proj(x) * keep
        if self.layer_norm is not None:
            x = self.layer_norm(x) * keep
        return x
