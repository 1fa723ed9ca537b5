"""Low-rank adaptation (LoRA) layers, channel-last [B, T, C].

Port of ``diff_vits_tpu/nn/lora.py``: an additive branch ``up(down(x))``
scaled by ``network_alpha / rank`` beside a Linear or a 1-D conv. ``down``
starts N(0, 1/rank), ``up`` at zero, so an adapted layer starts as its
base layer. The compatible wrappers hold the base layer as ``base`` and
the adapter as ``lora`` (none at ``rank`` 0), the flax names, so
``utils.convert`` carries their trees by its Dense and Conv rules.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.layers import Conv1d

IntOr1 = Union[int, Sequence[int]]


def _one(v: IntOr1) -> int:
    return v if isinstance(v, int) else int(tuple(v)[0])


def _flax_conv_pads(t: int, kernel_size: int, stride: int,
                    padding: str) -> Tuple[int, int]:
    """(left, right) frames flax's ``nn.Conv`` pads with "SAME" (output
    ceil(T / stride), the odd frame on the right) or "VALID" (none)."""
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}")
    out = -(-t // stride)
    total = max((out - 1) * stride + kernel_size - t, 0)
    return total // 2, total - total // 2


class _FlaxConv(Conv1d):
    """``Conv1d`` on [B, T, C] padded as flax pads ``padding``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: str = "SAME",
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, bias=bias)
        self.flax_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _flax_conv_pads(x.shape[1], self.kernel_size[0],
                               self.stride[0], self.flax_padding)
        return super().forward(F.pad(x, (0, 0) + pads))


class LoRALinearLayer(nn.Module):
    """rank-r adapter of a Linear (lora.py:21)."""

    def __init__(self, in_features: int, out_features: int, rank: int = 4,
                 network_alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rank > min(in_features, out_features):
            raise ValueError(f"LoRA rank {rank} must be <= "
                             f"{min(in_features, out_features)}")
        self.rank, self.network_alpha = rank, network_alpha
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)
        with torch.no_grad():
            self.down.weight.normal_(0.0, 1.0 / rank, generator=generator)
            self.up.weight.zero_()

    def forward(self, x):
        h = self.up(self.down(x))
        if self.network_alpha is not None:
            h = h * (self.network_alpha / self.rank)
        return h


class LoRAConv1dLayer(nn.Module):
    """rank-r adapter of a 1-D conv (lora.py:44): ``down`` has the base
    conv's kernel, stride and padding, ``up`` is 1x1."""

    def __init__(self, in_features: int, out_features: int, rank: int = 4,
                 kernel_size: IntOr1 = 1, strides: IntOr1 = 1,
                 padding: str = "SAME",
                 network_alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rank, self.network_alpha = rank, network_alpha
        self.down = _FlaxConv(in_features, rank, _one(kernel_size),
                              _one(strides), padding, bias=False)
        self.up = _FlaxConv(rank, out_features, 1, bias=False)
        with torch.no_grad():
            self.down.weight.normal_(0.0, 1.0 / rank, generator=generator)
            self.up.weight.zero_()

    def forward(self, x):
        h = self.up(self.down(x))
        if self.network_alpha is not None:
            h = h * (self.network_alpha / self.rank)
        return h


class LoRACompatibleDense(nn.Module):
    """Linear with an optional LoRA branch (lora.py:71; rank 0: none)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 rank: int = 0, network_alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base = nn.Linear(in_features, features, bias=use_bias)
        self.lora = (LoRALinearLayer(in_features, features, rank,
                                     network_alpha, generator)
                     if rank > 0 else None)

    def forward(self, x):
        y = self.base(x)
        return y if self.lora is None else y + self.lora(x)


class LoRACompatibleConv(nn.Module):
    """1-D conv with an optional LoRA branch (lora.py:91; rank 0: none)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: IntOr1 = 1, strides: IntOr1 = 1,
                 padding: str = "SAME", use_bias: bool = True, rank: int = 0,
                 network_alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base = _FlaxConv(in_features, features, _one(kernel_size),
                              _one(strides), padding, bias=use_bias)
        self.lora = (LoRAConv1dLayer(in_features, features, rank,
                                     kernel_size, strides, padding,
                                     network_alpha, generator)
                     if rank > 0 else None)

    def forward(self, x):
        y = self.base(x)
        return y if self.lora is None else y + self.lora(x)
