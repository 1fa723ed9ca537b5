"""DDPM beta schedule and the training-side buffers.

Port of ``linear_beta_schedule`` and of the parts of ``GaussianDiffusion``
of ``diff_vits_tpu/diffusion/schedule.py:17-90`` that the training loss
uses: the buffers (computed in float64, then cast to float32), forward
noising and the SNR loss weight (``min_snr_loss_weight=False``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear beta schedule in float64."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """float32 buffers [timesteps] on one device."""
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    loss_weight: torch.Tensor
    num_timesteps: int

    @staticmethod
    def create(timesteps: int = 1000, device=None) -> "GaussianDiffusion":
        alphas_cumprod = np.cumprod(1.0 - linear_beta_schedule(timesteps))
        snr = alphas_cumprod / (1 - alphas_cumprod)

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=device)
        return GaussianDiffusion(
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - alphas_cumprod)),
            loss_weight=f32(snr), num_timesteps=timesteps)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising of x_start [B, ...] to integer steps t [B]."""
        shape = (-1,) + (1,) * (x_start.dim() - 1)
        return (self.sqrt_alphas_cumprod[t].view(shape) * x_start
                + self.sqrt_one_minus_alphas_cumprod[t].view(shape) * noise)
