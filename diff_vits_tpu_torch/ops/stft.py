"""STFT and mel-spectrogram features in PyTorch.

Port of ``diff_vits_tpu/ops/stft.py``. The constants are part of the
model's contract and match torchaudio's defaults: n_fft 1024, hop 256,
win 1024, periodic Hann window, center with reflect padding, power-1
magnitude; mel: 100 bins, f_min 0, f_max sr / 2, HTK scale, no norm;
finally log(clip(x, 1e-7)).

The window and the filterbank are numpy arrays, as in the JAX package;
the transforms take tensors and return them on the caller's device (the
FFT is ``torch.fft.rfft``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default)."""
    n = np.arange(win_length)
    return (0.5 * (1 - np.cos(2 * np.pi * n / win_length))).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], HTK scale, no norm
    (``torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk')``).
    """
    f_max = f_max if f_max is not None else sr / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m_min, m_max = _hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                    # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]       # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def stft_magnitude(audio: torch.Tensor, n_fft: int = 1024,
                   hop_length: int = 256, win_length: Optional[int] = None,
                   center: bool = True) -> torch.Tensor:
    """Power-1 magnitude STFT of ``audio`` [..., T]: [..., frames, n_freqs]
    (frequency last), on ``audio``'s device."""
    win_length = win_length or n_fft
    window = torch.from_numpy(hann_window(win_length)).to(audio.device)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = F.pad(window, (pad, n_fft - win_length - pad))
    lead = audio.shape[:-1]
    if center:
        pad = n_fft // 2
        audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad),
                      mode="reflect").reshape(*lead, -1)
    frames = audio.unfold(-1, n_fft, hop_length) * window  # [..., F, n_fft]
    return torch.fft.rfft(frames, dim=-1).abs()


def log_mel_spectrogram(audio: torch.Tensor, sr: int = 24000,
                        n_fft: int = 1024, hop_length: int = 256,
                        n_mels: int = 100, f_min: float = 0.0,
                        f_max: Optional[float] = None,
                        clip_val: float = 1e-7) -> torch.Tensor:
    """log(clip(mel, 1e-7)) features [..., frames, n_mels]."""
    mag = stft_magnitude(audio, n_fft=n_fft, hop_length=hop_length)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, f_min,
                                         f_max)).to(mag.device)
    return torch.log(torch.clamp(mag @ fb, min=clip_val))


def log_linear_spectrogram(audio: torch.Tensor, n_fft: int = 1024,
                           hop_length: int = 256,
                           clip_val: float = 1e-7) -> torch.Tensor:
    """log power-1 linear spectrogram [..., frames, n_fft // 2 + 1]."""
    mag = stft_magnitude(audio, n_fft=n_fft, hop_length=hop_length)
    return torch.log(torch.clamp(mag, min=clip_val))
