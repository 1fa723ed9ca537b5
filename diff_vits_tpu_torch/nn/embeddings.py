"""Timestep and text-pooling embeddings of the diffusion UNet.

Port of ``diff_vits_tpu/nn/embeddings.py``: the sinusoidal timestep
embedding, the Gaussian Fourier projection, the timestep MLP, class-token
attention pooling and ``TextTimeEmbedding`` (also the VITS speaker
encoder over the prompt mel).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0,
                           scale: float = 1.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal DDPM timestep embedding [N, dim]."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of a continuous noise level
    (embeddings.py:37): [sin, cos] of 2 pi x w (of log x by default). The
    projection ``weight`` is drawn once at init and never trained: it is a
    parameter with ``requires_grad=False``, so it stays in the state dict
    (JAX: a param under ``stop_gradient``)."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0,
                 log: bool = True, flip_sin_to_cos: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.log, self.flip_sin_to_cos = log, flip_sin_to_cos
        self.weight = nn.Parameter(
            torch.randn(embedding_size, generator=generator) * scale,
            requires_grad=False)

    def forward(self, x):
        if self.log:
            x = torch.log(x)
        x_proj = x[:, None] * self.weight.detach()[None, :] * (2.0 * math.pi)
        parts = [torch.sin(x_proj), torch.cos(x_proj)]
        if self.flip_sin_to_cos:
            parts = parts[::-1]
        return torch.cat(parts, dim=-1)


class Timesteps(nn.Module):
    """UNet default: flip_sin_to_cos=True, shift 0. No parameters."""

    def __init__(self, num_channels: int, flip_sin_to_cos: bool = True,
                 downscale_freq_shift: float = 0.0):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift

    def forward(self, timesteps):
        return get_timestep_embedding(
            timesteps, self.num_channels,
            flip_sin_to_cos=self.flip_sin_to_cos,
            downscale_freq_shift=self.downscale_freq_shift)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class AttentionPooling(nn.Module):
    """Class-token attention pooling: q and k each scaled by d^-1/4, the
    softmax taken in float32 (embeddings.py:93-128)."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads, self.embed_dim = num_heads, embed_dim
        self.positional_embedding = nn.Parameter(torch.zeros(1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        bs = x.shape[0]
        d = self.embed_dim // self.num_heads
        class_token = (x.mean(dim=1, keepdim=True)
                       + self.positional_embedding.to(x.dtype))
        x_all = torch.cat([class_token, x], dim=1)

        def shape(t):
            return (t.reshape(bs, -1, self.num_heads, d).transpose(1, 2)
                    .reshape(bs * self.num_heads, -1, d))

        q = shape(self.q_proj(class_token))
        k, v = shape(self.k_proj(x_all)), shape(self.v_proj(x_all))
        scale = 1 / math.sqrt(math.sqrt(d))
        weight = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
        weight = torch.softmax(weight.float(), dim=-1).to(weight.dtype)
        a = torch.matmul(weight, v)
        return a.reshape(bs, self.embed_dim)


class TextTimeEmbedding(nn.Module):
    """LN -> AttentionPooling -> Linear -> LN (embeddings.py:131)."""

    def __init__(self, encoder_dim: int, time_embed_dim: int,
                 num_heads: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(encoder_dim, eps=1e-5)
        self.pool = AttentionPooling(num_heads, encoder_dim)
        self.proj = nn.Linear(encoder_dim, time_embed_dim)
        self.norm2 = nn.LayerNorm(time_embed_dim, eps=1e-5)

    def forward(self, hidden_states):
        return self.norm2(self.proj(self.pool(self.norm1(hidden_states))))
