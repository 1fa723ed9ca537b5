"""Static-shape training batches: crop and prompt split, padding, Batch.

A copy of ``random_slice``, ``pad_to`` and ``Batch`` of
``diff_vits_tpu/data/dataset.py:109-151`` (numpy, channel-last), filled
by the loaders of ``data.dataset`` and ``data.native_loader``.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np


def random_slice(mel: np.ndarray, rng: random.Random,
                 max_frames: int = 400, min_frames: int = 30):
    """Crop to ``max_frames`` and split a prompt span off: returns (spec,
    refer1 = the span of a third to two thirds of the frames, refer2 = the
    rest), or None for a mel shorter than ``min_frames``."""
    if mel.shape[0] < min_frames:
        return None
    if mel.shape[0] > max_frames:
        start = rng.randint(0, mel.shape[0] - max_frames)
        mel = mel[start:start + max_frames]
    len_mel = mel.shape[0]
    span = rng.randint(len_mel // 3, len_mel // 3 * 2)
    u = rng.randint(0, len_mel - span)
    v = u + span
    refer1 = mel[u:v]
    refer2 = np.concatenate([mel[:u], mel[v:]], axis=0)
    return mel, refer1, refer2


def pad_to(x: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """Zero-pad or cut ``x`` to ``length`` along ``axis``."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, max(0, length - x.shape[axis]))
    out = np.pad(x, pad)
    slc = [slice(None)] * x.ndim
    slc[axis] = slice(0, length)
    return out[tuple(slc)]


@dataclasses.dataclass
class Batch:
    """Static-shape training batch (channel-last)."""
    text: np.ndarray            # [B, Tx] int
    tone: np.ndarray            # [B, Tx]
    language: np.ndarray        # [B, Tx]
    spec: np.ndarray            # [B, Ty, C]
    refer1: np.ndarray          # [B, S1, C]
    refer2: np.ndarray          # [B, S2, C]
    text_lengths: np.ndarray    # [B]
    spec_lengths: np.ndarray    # [B]
    refer1_lengths: np.ndarray  # [B]
    refer2_lengths: np.ndarray  # [B]
