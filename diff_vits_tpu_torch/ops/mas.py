"""Monotonic alignment search (MAS): kernel K6.

Port of ``diff_vits_tpu/ops/mas.py:28-103`` (the Viterbi forward DP as a
``lax.scan`` and its backtrack) and of the Pallas kernel that replaces it,
``maximum_path_pallas`` of ``diff_vits_tpu/ops/mas_pallas.py:89``. The
edge rules are those of ``ops/mas.py:10-16``:

  * value[y, x] = raw[y, x] + max(v_cur, v_prev) inside the band
    [max(0, t_x + y - t_y), min(t_x, y + 1)); the raw score outside it;
  * v_cur = value[y-1, x], -1e9 when x == y;
  * v_prev = value[y-1, x-1]; at x == 0 it is 0 when y == 0, else -1e9;
  * the backtrack starts at t_x - 1 and moves left at row y when
    ``x != 0 and (x == y or value[y-1, x] < value[y-1, x-1])``.

On a CPU tensor the plain PyTorch version below runs (vectorised over
(B, Tx), a loop over Ty). On a CUDA tensor ``csrc/mas.cu`` runs, one block
per batch element (the DP row in the registers of a few warps, the scores
staged ahead by the block's other warps, the path zeroed by a second block
of the item's cluster), or the call raises; its design note says what
bounds it. In PyTorch eager the plain version is two loops of Ty steps
with several launches each, so the kernel is the port's MAS on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from diff_vits_tpu_torch.ops import _cuda

_NEG = -1e9


def _lengths(mask: torch.Tensor):
    """(t_y, t_x) [B] from the mask, as the reference derives them."""
    t_ys = mask.sum(dim=1)[:, 0].to(torch.int64)
    t_xs = mask.sum(dim=2)[:, 0].to(torch.int64)
    return t_ys, t_xs


def maximum_path_plain(neg_cent: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch MAS. neg_cent, mask: [B, Ty, Tx]. Returns the hard
    path [B, Ty, Tx] (times the mask) in neg_cent's dtype."""
    dtype = neg_cent.dtype
    nc = neg_cent.float()
    b, t_y_max, t_x_max = nc.shape
    t_ys, t_xs = _lengths(mask)
    x_idx = torch.arange(t_x_max, device=nc.device)[None, :]

    prev = nc.new_zeros(b, t_x_max)
    values = []
    for y in range(t_y_max):
        v_cur = torch.where(x_idx == y, _NEG, prev)
        shifted = F.pad(prev[:, :-1], (1, 0))
        v_prev = torch.where(x_idx == 0, 0.0 if y == 0 else _NEG, shifted)
        acc = nc[:, y] + torch.maximum(v_cur, v_prev)
        lower = torch.clamp(t_xs + y - t_ys, min=0)[:, None]
        upper = torch.clamp(t_xs, max=y + 1)[:, None]
        in_band = (x_idx >= lower) & (x_idx < upper)
        prev = torch.where(in_band, acc, nc[:, y])
        values.append(prev)

    index = t_xs - 1
    rows = []
    for y in range(t_y_max - 1, -1, -1):
        active = y < t_ys
        rows.append((active[:, None] & (x_idx == index[:, None])).float())
        row_prev = values[max(y - 1, 0)]
        v_at = row_prev.gather(1, index.clamp(min=0)[:, None])[:, 0]
        v_left = row_prev.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        move = (index != 0) & ((index == y) | (v_at < v_left))
        index = torch.where(active & move, index - 1, index)
    path = torch.stack(rows[::-1], dim=1)
    return (path * mask.float()).to(dtype)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS. neg_cent: [B, Ty, Tx] scores (mel frames x text); mask:
    [B, Ty, Tx] (the outer product of the two masks). Returns the hard path
    [B, Ty, Tx] in neg_cent's dtype, zero outside the mask.

    CUDA route: neg_cent float32 or bfloat16, contiguous; the mask is read
    as float32."""
    if neg_cent.device.type == "cpu":
        return maximum_path_plain(neg_cent, mask)
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path runs on cpu or cuda, not "
                         f"{neg_cent.device}")
    return _kernel(neg_cent, mask)


def _kernel(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel route: check every input, then launch."""
    if neg_cent.dim() != 3:
        raise ValueError(f"neg_cent must be [B, Ty, Tx], got "
                         f"{tuple(neg_cent.shape)}")
    b, t_y, t_x = neg_cent.shape
    if tuple(mask.shape) != (b, t_y, t_x) or mask.device != neg_cent.device:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} does "
                         f"not match neg_cent {tuple(neg_cent.shape)} on "
                         f"{neg_cent.device}")
    if not neg_cent.is_contiguous():
        raise ValueError("neg_cent must be contiguous")
    nc_dt = _cuda.dtype_flag(neg_cent)
    mask = mask.to(torch.float32).contiguous()
    path = torch.empty_like(neg_cent)
    # csrc/mas.cu refuses a shape whose columns or move bits do not fit
    # one block (dvt_mas states the limits)
    _cuda.check(_cuda.fn("mas.cu", "dvt_mas")(
        neg_cent.data_ptr(), nc_dt, mask.data_ptr(), path.data_ptr(), nc_dt,
        b, t_y, t_x, _cuda.stream_ptr(neg_cent)),
        f"MAS kernel at Ty={t_y}, Tx={t_x}")
    maximum_path.launches += 1
    return path


maximum_path.launches = 0
