"""F0 extraction, interpolation and coarse quantisation.

Port of ``diff_vits_tpu/utils/f0.py``: ``compute_f0`` (:20), a
dependency-free autocorrelation pitch tracker, ``interpolate_f0`` (:48)
and ``f0_to_coarse`` (:63). Where JAX's loops over frames with
``np.correlate``, the port cuts every frame at once (``unfold``) and takes
all their autocorrelations through one zero-padded real FFT, in float64,
on the device of the tensor it is given.
"""
from __future__ import annotations

import math

import torch

f0_bin = 256
f0_max = 1100.0
f0_min = 50.0
f0_mel_min = 1127 * math.log(1 + f0_min / 700)
f0_mel_max = 1127 * math.log(1 + f0_max / 700)


def compute_f0(wav, sampling_rate: int = 24000, hop_length: int = 256,
               fmin: float = f0_min, fmax: float = f0_max,
               threshold: float = 0.3) -> torch.Tensor:
    """Frame-wise f0 [n_frames] float32 (0 = unvoiced) of a mono wav [T]
    by normalised autocorrelation: frames of 2 sr // fmin samples every
    ``hop_length``, the lag of the highest normalised autocorrelation in
    [sr / fmax, sr / fmin), voiced where it exceeds ``threshold``."""
    wav = torch.as_tensor(wav).to(torch.float64)
    frame_len = int(sampling_rate // fmin) * 2
    n = wav.shape[0]
    n_frames = (max(1, 1 + (n - frame_len) // hop_length)
                if n >= frame_len else 1)
    wav = torch.nn.functional.pad(
        wav, (0, max(0, frame_len + n_frames * hop_length - n)))
    lag_min = int(sampling_rate / fmax)
    lag_max = int(sampling_rate / fmin)
    f0 = torch.zeros(n_frames, dtype=torch.float32, device=wav.device)
    if lag_max <= lag_min:
        return f0
    frames = wav.unfold(0, frame_len, hop_length)[:n_frames]
    frames = frames - frames.mean(dim=1, keepdim=True)
    energy = (frames * frames).sum(dim=1)
    # the linear autocorrelation of each frame: zero padding to 2 frame_len
    # or more keeps the circular one from wrapping
    n_fft = 1 << (2 * frame_len - 1).bit_length()
    spec = torch.fft.rfft(frames, n=n_fft)
    corr = torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=n_fft)
    corr = corr[:, :frame_len] / (corr[:, :1] + 1e-12)
    seg = corr[:, lag_min:lag_max]
    lag = seg.argmax(dim=1)
    best = seg.gather(1, lag[:, None])[:, 0]
    lag = (lag + lag_min).to(torch.float64)
    voiced = (energy >= 1e-8) & (best > threshold)
    return torch.where(voiced, sampling_rate / lag,
                       torch.zeros_like(lag)).to(torch.float32)


def interpolate_f0(f0):
    """Linear interpolation over unvoiced (0) frames, held flat beyond the
    first and last voiced ones, as ``np.interp`` does. Returns
    (interpolated f0, voiced mask), both float32 on f0's device."""
    f0 = torch.as_tensor(f0).to(torch.float32)
    vuv = (f0 > 0).to(torch.float32)
    voiced = torch.nonzero(f0 > 0).flatten()
    if voiced.numel() == 0:
        return f0.clone(), vuv
    xp = voiced.to(torch.float64)
    fp = f0[voiced].to(torch.float64)
    x = torch.arange(f0.shape[0], dtype=torch.float64, device=f0.device)
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                    max(xp.numel() - 2, 0))
    if xp.numel() > 1:
        slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
        out = slope * (x - xp[j]) + fp[j]
    else:
        out = fp[j]
    out = torch.where(x == xp[j], fp[j], out)
    out = torch.where(x < xp[0], fp[0], out)
    out = torch.where(x >= xp[-1], fp[-1], out)
    return out.to(torch.float32), vuv


def f0_to_coarse(f0) -> torch.Tensor:
    """Quantise f0 to mel-spaced bins in [1, 255] (int64; 1 where f0 is
    0)."""
    f0 = torch.as_tensor(f0).to(torch.float64)
    f0_mel = 1127 * torch.log(1 + f0 / 700)
    scaled = ((f0_mel - f0_mel_min) * (f0_bin - 2)
              / (f0_mel_max - f0_mel_min) + 1)
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    coarse = torch.round(torch.clamp(f0_mel, 1, f0_bin - 1)).to(torch.int64)
    return torch.where(f0 == 0, torch.ones_like(coarse), coarse)
