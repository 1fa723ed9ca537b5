"""Normalizing-flow steps (VITS coupling flows), channel-last [B, T, C].

Port of ``diff_vits_tpu/nn/flows.py:22-196``: ``Log``, ``Flip``,
``ElementwiseAffine``, ``ResidualCouplingLayer``, ``ConvFlow`` and
``TransformerCouplingLayer``. Each step takes ``reverse``; the forward
returns (y, logdet [B]) and the reverse y only, as in the JAX package.

``ConvFlow``'s reverse (the sampling path of the stochastic duration
predictor) evaluates its spline through kernel K7
(``ops.spline.unconstrained_rqs``: the CUDA kernel on the card, the plain
spline in float32 on the CPU) unless ``use_fused`` is False; its forward
(the duration NLL) keeps the plain, differentiable spline in the module's
dtype, as the JAX module keeps its XLA formulation there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.nn.layers import WN, DDSConv, Encoder
from diff_vits_tpu_torch.ops.spline import (
    piecewise_rational_quadratic_transform, unconstrained_rqs)


class Log(nn.Module):
    """y = log(max(x, 1e-5)) * mask, logdet = -sum(y); reverse exp."""

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    """Channel flip (logdet 0)."""

    def forward(self, x, *args, reverse: bool = False, **kwargs):
        x = torch.flip(x, dims=(-1,))
        if not reverse:
            return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return x


class ElementwiseAffine(nn.Module):
    """y = (m + exp(logs) * x) * mask."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


def _couple(x0, x1, stats, x_mask, half: int, mean_only: bool,
            reverse: bool):
    """Affine coupling of x1 by (m, logs) = stats."""
    if mean_only:
        m, logs = stats, torch.zeros_like(stats)
    else:
        m, logs = stats[..., :half], stats[..., half:]
    if not reverse:
        x1 = m + x1 * torch.exp(logs) * x_mask
        return torch.cat([x0, x1], dim=-1), torch.sum(logs, dim=(1, 2))
    x1 = (x1 - m) * torch.exp(-logs) * x_mask
    return torch.cat([x0, x1], dim=-1)


class ResidualCouplingLayer(nn.Module):
    """Affine coupling over a WN stack (flows.py:60-95)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = False):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = nn.Linear(self.half, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = nn.Linear(hidden_channels,
                              self.half * (1 if mean_only else 2))

    def forward(self, x, x_mask, g=None, reverse: bool = False, *,
                generator: Optional[torch.Generator] = None):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        stats = self.post(h) * x_mask
        return _couple(x0, x1, stats, x_mask, self.half, self.mean_only,
                       reverse)


class TransformerCouplingLayer(nn.Module):
    """Affine coupling over a rel-pos attention Encoder (flows.py:160-196);
    the Encoder's attention runs through K5 on the card in eval mode."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 n_layers: int, n_heads: int, p_dropout: float = 0.0,
                 filter_channels: int = 0, mean_only: bool = False,
                 gin_channels: int = 0):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = nn.Linear(self.half, hidden_channels)
        self.enc = Encoder(hidden_channels, filter_channels, n_heads,
                           n_layers, kernel_size, p_dropout,
                           gin_channels=gin_channels)
        self.post = nn.Linear(hidden_channels,
                              self.half * (1 if mean_only else 2))

    def forward(self, x, x_mask, g=None, reverse: bool = False, *,
                generator: Optional[torch.Generator] = None):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g, generator=generator)
        stats = self.post(h) * x_mask
        return _couple(x0, x1, stats, x_mask, self.half, self.mean_only,
                       reverse)


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling over a DDSConv (flows.py:98-157).
    The projection is read as [B, T, half, 3 * num_bins - 1]: widths,
    heights (both scaled by 1 / sqrt(filter_channels)) and the interior
    derivatives."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0, use_fused: bool = True):
        super().__init__()
        self.use_fused = use_fused
        self.half, self.num_bins = in_channels // 2, num_bins
        self.filter_channels, self.tail_bound = filter_channels, tail_bound
        self.pre = nn.Linear(self.half, filter_channels)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = nn.Linear(filter_channels,
                              self.half * (num_bins * 3 - 1))

    def forward(self, x, x_mask, g=None, reverse: bool = False, *,
                generator: Optional[torch.Generator] = None):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.convs(self.pre(x0), x_mask, g=g)
        h = self.proj(h) * x_mask
        b, t, _ = x0.shape
        nb = self.num_bins
        h = h.reshape(b, t, self.half, nb * 3 - 1)
        scale = math.sqrt(self.filter_channels)
        uw, uh, ud = h[..., :nb] / scale, h[..., nb:2 * nb] / scale, \
            h[..., 2 * nb:]
        if reverse and self.use_fused:
            x1, logabsdet = unconstrained_rqs(
                x1, uw, uh, ud, inverse=True, tail_bound=self.tail_bound)
        else:
            x1, logabsdet = piecewise_rational_quadratic_transform(
                x1, uw, uh, ud, inverse=reverse, tails="linear",
                tail_bound=self.tail_bound)
        x_out = torch.cat([x0, x1], dim=-1) * x_mask
        if reverse:
            return x_out
        return x_out, torch.sum(logabsdet * x_mask, dim=(1, 2))
