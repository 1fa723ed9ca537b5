"""Scaled-dot-product attention with causal and key-padding masks.

Port of ``diff_vits_tpu/ops/attention.py``: the functional SDPA of the
reference's ``Attend`` (unused by the model's path). The JAX package runs
it as plain XLA ops, not a Pallas kernel, so the port runs it as plain
tensor ops on either device.
"""
from __future__ import annotations

from typing import Optional

import torch


def scaled_dot_product_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        causal: bool = False,
        scale: Optional[float] = None) -> torch.Tensor:
    """SDPA over [B, H, T, D] tensors. ``mask``: boolean keep-mask
    broadcastable to [B, H, Tq, Tk]; ``bias``: additive, broadcastable to
    the scores; ``causal``: query i keeps keys j <= i + Tk - Tq. A query
    that keeps no key gives 0, not NaN."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=scores.device).tril(t_k - t_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    if mask is not None or causal:
        p = torch.nan_to_num(p, nan=0.0)
    return torch.matmul(p, v)


def attend(q, k, v, key_padding_mask: Optional[torch.Tensor] = None,
           causal: bool = False) -> torch.Tensor:
    """``Attend``-shaped entry: q/k/v [B, H, T, D]; a boolean key-padding
    keep-mask [B, Tk]."""
    mask = None
    if key_padding_mask is not None:
        mask = key_padding_mask[:, None, None, :]
    return scaled_dot_product_attention(q, k, v, mask=mask, causal=causal)
