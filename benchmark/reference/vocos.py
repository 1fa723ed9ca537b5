"""Vocos, the mel -> waveform vocoder of the reference, at the published
charactr/vocos-mel-24khz widths: embedding conv (k7), LayerNorm, 8
ConvNeXt blocks (dim 512, intermediate 1536), LayerNorm, Linear to
magnitude and phase, inverse STFT (n_fft 1024, hop 256, centred, Hann
window, overlap-add normalised by the window envelope). Copied from the
port; parameter names match its state dict."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1.0 / 8))

    def forward(self, x):
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        return x + self.gamma * self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))


def istft(real, imag, n_fft: int, hop_length: int) -> torch.Tensor:
    """Inverse STFT, as torch.istft(center=True) with a periodic Hann
    window; the imaginary parts of DC and Nyquist are dropped."""
    n = torch.arange(n_fft, device=real.device, dtype=torch.float64)
    window = (0.5 * (1 - torch.cos(2 * torch.pi * n / n_fft))).float()
    keep = torch.ones(real.shape[-1], device=real.device)
    keep[0] = keep[-1] = 0
    frames = torch.fft.irfft(torch.complex(real, imag * keep), n=n_fft,
                             dim=-1) * window
    b, n_frames, _ = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols):
        return F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft),
                      stride=(1, hop_length))[:, 0, 0]

    audio = overlap_add(frames.transpose(1, 2))
    env = overlap_add((window ** 2)[None, :, None].expand(1, n_fft, n_frames))
    audio = audio / torch.clamp(env, min=1e-11)
    return audio[:, n_fft // 2:out_len - n_fft // 2]


class Vocos(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, (T - 1) * hop] float32."""

    def __init__(self, n_mels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.num_layers = num_layers
        self.embed = nn.Conv1d(n_mels, dim, 7, padding=3)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        for i in range(num_layers):
            self.add_module(f"convnext_{i}",
                            ConvNeXtBlock(dim, intermediate_dim))
        self.final_norm = nn.LayerNorm(dim, eps=1e-6)
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, mel):
        h = self.norm(self.embed(mel.transpose(1, 2)).transpose(1, 2))
        for i in range(self.num_layers):
            h = getattr(self, f"convnext_{i}")(h)
        mag, phase = self.out(self.final_norm(h)).float().chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                     self.n_fft, self.hop_length)
