"""Random weights from a seed, for running the port without a checkpoint."""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` (a CPU generator): matrices
    and conv kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.02^2), biases
    and 1-d tables N(0, 0.02^2). Deterministic given the seed and the
    module tree."""
    norms = (nn.LayerNorm, nn.GroupNorm)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            noise = torch.randn(p.shape, generator=generator)
            if p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                value = noise / math.sqrt(fan_in)
            elif isinstance(module, norms) and name == "weight":
                value = 1.0 + 0.02 * noise
            else:
                value = 0.02 * noise
            p.copy_(value.to(p.dtype))
    return model
