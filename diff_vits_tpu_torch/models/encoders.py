"""Text prior encoder, mel posterior encoder, prompt refiner and the two
speaker encoders off the main path, channel-last [B, T, C].

Port of ``TextEncoder``, ``PosteriorEncoder``, ``PromptEncoder``,
``ReferenceEncoder`` and ``SpeakerEncoder`` of
``diff_vits_tpu/models/encoders.py``. Dropout is active in ``train()``
mode only and draws from the ``generator`` the caller passes. The JAX
recurrences (a ``lax.scan`` of a ``GRUCell``, ``nn.RNN`` of
``OptimizedLSTMCell``s) are ``torch.nn.GRU`` / ``LSTM`` here;
``utils.convert`` packs the flax cells' per-gate denses into them.
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


class ReferenceEncoder(nn.Module):
    """GST-style reference encoder (encoders.py:139): six 3x3 stride-2
    convs (32, 32, 64, 64, 128, 128 channels, padding 1, ReLU) over the
    [time, mel] plane, the [B, T', F', C] features flattened per frame
    (F' x C, channels fastest, as flax's NHWC reshape), a 128-unit GRU over
    the frames from a zero state, and its last state projected to
    ``gin_channels``."""

    FILTERS = (32, 32, 64, 64, 128, 128)

    def __init__(self, spec_channels: int, gin_channels: int = 0, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f, c_in = spec_channels, 1
        for i, ch in enumerate(self.FILTERS):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, ch, 3, stride=2,
                                                   padding=1))
            c_in, f = ch, (f - 1) // 2 + 1
        self.gru = nn.GRU(f * c_in, 128, batch_first=True)
        self.proj = nn.Linear(128, gin_channels)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, inputs):
        """inputs [B, Ty, n_mels] -> [B, gin_channels]."""
        x = inputs[:, None]                     # [B, 1, Ty, n_mels]
        for i in range(len(self.FILTERS)):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        _, h = self.gru(x)
        return self.proj(h[0])


class SpeakerEncoder(nn.Module):
    """LSTM d-vector speaker encoder (encoders.py:169): ``model_num_layers``
    stacked LSTMs (``lstm_i``, zero initial states), ReLU(Linear) of the
    last frame's output, L2-normalised. ``mel_n_channels`` is the input
    width, which flax reads from the data."""

    def __init__(self, mel_n_channels: int, model_hidden_size: int = 256,
                 model_embedding_size: int = 256, model_num_layers: int = 2,
                 *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = model_num_layers
        for i in range(model_num_layers):
            self.add_module(f"lstm_{i}", nn.LSTM(
                mel_n_channels if i == 0 else model_hidden_size,
                model_hidden_size, batch_first=True))
        self.linear = nn.Linear(model_hidden_size, model_embedding_size)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, mels):
        """mels [B, T, n_mels] -> [B, model_embedding_size], unit norm."""
        h = mels
        for i in range(self.num_layers):
            h, _ = getattr(self, f"lstm_{i}")(h)
        emb = torch.relu(self.linear(h[:, -1]))
        return emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
