"""Content-feature helpers.

Port of ``diff_vits_tpu/utils/content.py``: ``repeat_expand_2d`` (:16),
the nearest-span expansion of [C, T] features to a target length, as one
gather on the tensor's device, and ``ContentExtractor`` (:28), a pluggable
wav -> content-feature callable. ``ContentExtractor.from_transformers``
(:41, a HuBERT model through the ``transformers`` package) is not ported:
neither the package nor the weights are available to the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def repeat_expand_2d(content: torch.Tensor, target_len: int) -> torch.Tensor:
    """Expand [C, T_src] -> [C, target_len]: output frame i copies the
    source frame p with the largest boundary p target_len / T_src <= i."""
    content = torch.as_tensor(content)
    src_len = content.shape[-1]
    bounds = (torch.arange(1, src_len + 1, device=content.device)
              * target_len).to(torch.float64) / src_len
    frames = torch.arange(target_len, device=content.device,
                          dtype=torch.float64)
    pos = torch.searchsorted(bounds, frames, right=True).clamp_max(
        src_len - 1)
    return content[:, pos].contiguous()


class ContentExtractor:
    """Pluggable wav -> content-feature extractor: ``fn(wav_16k [T]
    float32 tensor) -> [C, T']``."""

    def __init__(self, fn: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None):
        self._fn = fn

    def __call__(self, wav_16k) -> torch.Tensor:
        if self._fn is None:
            raise RuntimeError(
                "no content model configured; construct ContentExtractor "
                "with a callable (the transformers HuBERT loader is not "
                "ported)")
        return self._fn(torch.as_tensor(wav_16k).to(torch.float32))
