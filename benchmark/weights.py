"""Random weights from a seed, made on the device in one draw.

Every parameter of a module tree is a slice of one standard normal draw
from a generator on ``device``, scaled as the port's ``init_random``
scales them: matrices and conv kernels N(0, 1/fan_in), norm scales 1 +
N(0, 0.02^2), biases and 1-d tables N(0, 0.02^2). The names and shapes
come from the reference's module tree, whose state dict names are the
port's, so the same state dict loads into both.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

_NORMS = (nn.LayerNorm, nn.GroupNorm)


def make_state_dict(model: nn.Module, seed: int, device,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A state dict of ``model``'s parameters (in ``dtype`` on ``device``)
    drawn from ``seed``. ``model`` may live on the meta device."""
    leaves = []
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            if p.dim() >= 2:
                scale, shift = 1.0 / math.sqrt(math.prod(p.shape[1:])), 0.0
            elif isinstance(module, _NORMS) and name == "weight":
                scale, shift = 0.02, 1.0
            else:
                scale, shift = 0.02, 0.0
            leaves.append((key, tuple(p.shape), scale, shift))
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for key, shape, scale, shift in leaves:
        n = math.prod(shape)
        out[key] = (flat[off:off + n].view(shape) * scale + shift).to(dtype)
        off += n
    return out
