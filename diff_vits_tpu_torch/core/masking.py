"""Mask and alignment-path utilities, channel-last [B, T, C].

Port of ``diff_vits_tpu/core/masking.py:18-85``: the masks and paths of
inference and the KL terms of the training loss, and ``intersperse`` of
the text frontend.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, TypeVar

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


def kl_divergence(m_p, logs_p, m_q, logs_q):
    """KL(P || Q) between diagonal Gaussians, elementwise."""
    kl = (logs_q - logs_p) - 0.5
    return kl + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2) \
        * torch.exp(-2.0 * logs_q)


Reduce = Callable[[torch.Tensor], torch.Tensor]


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask,
            rank_mean: Optional[Reduce] = None):
    """Masked mean KL of the VITS prior loss in float32: the sum over the
    mask divided by the sum of the mask. z_p, logs_q, m_p, logs_p:
    [B, T, C]; z_mask: [B, T, 1] (so the divisor counts frames).
    ``rank_mean`` (data parallelism: a statistic -> its mean over the
    ranks) makes the divisor the mean of the ranks' mask sums, so that the
    ranks' mean gradient is that of the global batch."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        a.float() for a in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / denominator(torch.sum(z_mask),
                                                rank_mean)


def denominator(d: torch.Tensor, rank_mean: Optional[Reduce]) -> torch.Tensor:
    """``d``, or its mean over the data-parallel ranks (without a
    gradient) when ``rank_mean`` is given."""
    return d if rank_mean is None else rank_mean(d.detach())


T = TypeVar("T")


def intersperse(lst: Sequence[T], item: T) -> List[T]:
    """Insert ``item`` between (and around) every element."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = list(lst)
    return result
