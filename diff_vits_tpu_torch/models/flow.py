"""Flow blocks over the latent (the model2 / bv2 spec flows).

Port of ``ResidualCouplingBlock`` and ``TransformerCouplingBlock`` of
``diff_vits_tpu/models/flow.py``: n_flows mean-only coupling layers
(``flow_{i}``), each followed by a channel flip (``flip_{i}``); the
reverse runs the steps in reversed order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.nn.flows import (
    Flip, ResidualCouplingLayer, TransformerCouplingLayer)


class _CouplingBlock(nn.Module):
    def _steps(self):
        for i in range(self.n_flows):
            yield getattr(self, f"flow_{i}")
            yield getattr(self, f"flip_{i}")

    def forward(self, x, x_mask, g=None, reverse: bool = False, *,
                generator: Optional[torch.Generator] = None):
        steps = list(self._steps())
        if not reverse:
            for step in steps:
                if isinstance(step, Flip):
                    x, _ = step(x, x_mask, reverse=False)
                else:
                    x, _ = step(x, x_mask, g=g, generator=generator)
            return x
        for step in reversed(steps):
            if isinstance(step, Flip):
                x = step(x, x_mask, reverse=True)
            else:
                x = step(x, x_mask, g=g, reverse=True, generator=generator)
        return x


class ResidualCouplingBlock(_CouplingBlock):
    """WN coupling layers (model3.py:435-477)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels=gin_channels, mean_only=True))
            self.add_module(f"flip_{i}", Flip())
        self.to(device=resolve_device(device), dtype=dtype)


class TransformerCouplingBlock(_CouplingBlock):
    """Rel-pos attention coupling layers (model3.py:56-119)."""

    def __init__(self, channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0, n_flows: int = 4,
                 gin_channels: int = 0, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flow_{i}", TransformerCouplingLayer(
                channels, hidden_channels, kernel_size, n_layers, n_heads,
                p_dropout, filter_channels, mean_only=True,
                gin_channels=gin_channels))
            self.add_module(f"flip_{i}", Flip())
        self.to(device=resolve_device(device), dtype=dtype)
