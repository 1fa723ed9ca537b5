"""Mask and alignment-path utilities, channel-last [B, T, C].

Port of ``diff_vits_tpu/core/masking.py``: the masks and paths of
inference, the KL terms of the training loss, ``intersperse`` of the text
frontend, and the sequence helpers off the main path (the torch-order pad
list, segment slicing, the causal mask, the sinusoidal timing signal).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

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
    path[b, y, x] = 1 iff frame y belongs to token x. The frame positions
    are counted in float32 whatever the dtype of ``duration``: in bfloat16
    a running sum or a frame index past 256 rounds, which would put frames
    on the wrong token.
    """
    t_y = mask.shape[1]
    cum = torch.cumsum(duration.float(), dim=-1)
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


def convert_pad_shape(pad_shape: Sequence[Sequence[int]]) -> List[int]:
    """[[before, after] per dim, first dim first] -> ``F.pad``'s flat list
    (last dim first)."""
    return [item for sublist in pad_shape[::-1] for item in sublist]


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """x [B, T, C], ids_str [B] -> [B, segment_size, C], item b's frames
    ids_str[b] .. ids_str[b] + segment_size - 1. A start past T -
    segment_size is moved back to T - segment_size, as
    ``lax.dynamic_slice`` clamps it."""
    t = x.shape[1]
    start = ids_str.to(x.device).long().clamp(0, max(t - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor,
                        segment_size: int,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random slices of ``segment_size`` frames: item b starts at
    floor(u * max(lengths[b] - segment_size + 1, 1)), u ~ U[0, 1) drawn
    from ``generator`` (on x's device). Returns (slices, ids_str)."""
    b = x.shape[0]
    ids_str_max = torch.clamp(lengths.to(x.device) - segment_size + 1, min=1)
    u = torch.rand((b,), generator=generator, device=x.device)
    ids_str = (u * ids_str_max).to(torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


def subsequent_mask(length: int, device=None) -> torch.Tensor:
    """Lower-triangular causal mask [1, 1, T, T] (float, 1 = keep)."""
    return torch.tril(torch.ones(length, length, device=device))[None, None]


def get_timing_signal_1d(length: int, channels: int,
                         min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4,
                         device=None) -> torch.Tensor:
    """Sinusoidal timing signal [1, T, C] (sin half, then cos half; an odd
    channel count gets a zero last channel)."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = channels // 2
    log_timescale_increment = math.log(max_timescale / min_timescale) / max(
        num_timescales - 1, 1)
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    scaled_time = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)],
                       dim=1)
    return F.pad(signal, (0, channels % 2))[None]
