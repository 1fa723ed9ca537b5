"""Mask and alignment-path utilities, channel-last [B, T, C].

Port of ``diff_vits_tpu/core/masking.py:18-50`` (the inference subset).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask [B, T]: True for positions < length."""
    pos = torch.arange(max_length, device=lengths.device,
                       dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Expand per-token frame counts into a hard monotonic alignment.

    duration: [B, Tx]; mask: [B, Ty, Tx]. Returns path [B, Ty, Tx] with
    path[b, y, x] = 1 iff frame y belongs to token x.
    """
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)
    frame = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    below = frame[None, :, None] < cum[:, None, :]
    below_prev = F.pad(below[:, :, :-1], (1, 0))
    path = below & ~below_prev
    return path.to(mask.dtype) * mask
