"""The control's precision: float8 (e4m3) products.

Inside ``fp8_products(model)`` every ``nn.Linear`` and ``nn.Conv1d`` of
``model`` multiplies its input and its weight rounded to e4m3, each at one
scale a tensor (its largest magnitude at e4m3's largest finite value,
448), as an fp8 GEMM over float32 master weights sees them; products,
sums and everything else stay float32. Gradients pass the rounding
unchanged (straight through), so a training step updates the float32
weights. The layers' own forwards come back on exit.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at one per-tensor scale, in ``t``'s dtype,
    with the gradient of the identity."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


@contextlib.contextmanager
def fp8_products(model: nn.Module):
    patched = []
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.forward = (lambda mod: lambda x: F.linear(
                round_e4m3(x), round_e4m3(mod.weight), mod.bias))(m)
            patched.append((m, "forward"))
        elif isinstance(m, nn.Conv1d):
            m._conv_forward = (lambda mod: lambda x, w, b: nn.Conv1d.
                               _conv_forward(mod, round_e4m3(x),
                                             round_e4m3(w), b))(m)
            patched.append((m, "_conv_forward"))
    try:
        yield model
    finally:
        for m, attr in patched:
            delattr(m, attr)
