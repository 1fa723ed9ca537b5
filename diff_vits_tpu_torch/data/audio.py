"""Host-side audio IO and feature extraction (numpy and scipy, no card).

Port of ``diff_vits_tpu/data/audio.py``: wav read and write, polyphase
resampling, and a numpy STFT / log-mel that never touches the card, so
offline preprocessing does not take the device (``ops.stft`` holds the
same transforms on tensors).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from diff_vits_tpu_torch.ops.stft import hann_window, mel_filterbank


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono [T], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int = 24000):
    """Write float audio in [-1, 1] (clipped) as 16-bit PCM."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (audio * 32767.0).astype(np.int16))


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (band-limited, like torchaudio's kaiser)."""
    if sr_in == sr_out:
        return audio
    g = math.gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def _stft_mag_np(audio: np.ndarray, n_fft: int,
                 hop_length: int) -> np.ndarray:
    """Power-1 magnitude STFT [frames, n_fft // 2 + 1] in numpy: the math
    of ``ops.stft.stft_magnitude`` on the host."""
    window = hann_window(n_fft)
    pad = n_fft // 2
    audio = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(audio) - n_fft) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = audio[idx] * window
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def log_mel(audio: np.ndarray, sr: int = 24000, n_fft: int = 1024,
            hop_length: int = 256, n_mels: int = 100) -> np.ndarray:
    """log-mel features [frames, n_mels]."""
    mag = _stft_mag_np(np.asarray(audio, np.float32), n_fft, hop_length)
    fb = mel_filterbank(sr, n_fft, n_mels)
    return np.log(np.clip(mag @ fb, 1e-7, None)).astype(np.float32)


def log_linear(audio: np.ndarray, n_fft: int = 1024,
               hop_length: int = 256) -> np.ndarray:
    """log linear spectrogram [frames, n_fft // 2 + 1]."""
    mag = _stft_mag_np(np.asarray(audio, np.float32), n_fft, hop_length)
    return np.log(np.clip(mag, 1e-7, None)).astype(np.float32)
