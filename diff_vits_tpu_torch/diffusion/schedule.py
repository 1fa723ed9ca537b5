"""DDPM beta schedule, forward noising and the DDPM / DDIM sampling loops.

Port of ``linear_beta_schedule`` and ``GaussianDiffusion`` of
``diff_vits_tpu/diffusion/schedule.py:17-164``: the buffers (computed in
float64, then cast to float32), forward noising, the SNR loss weight
(``min_snr_loss_weight=False``), the posterior, ancestral DDPM sampling
(``p_sample_loop``, one model call a step) and DDIM (``ddim_sample``).
The JAX package compiles the loops into one program; here they are Python
loops over integer steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _draw(like: torch.Tensor,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """A standard normal draw of ``like``'s shape on ``like``'s device, made
    on the generator's device (the default generator of ``like``'s device
    without one)."""
    where = generator.device if generator is not None else like.device
    return torch.randn(like.shape, generator=generator, device=where,
                       dtype=torch.float32).to(like.device)


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear beta schedule in float64."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """float32 buffers [timesteps] on one device."""
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor
    num_timesteps: int

    @staticmethod
    def create(timesteps: int = 1000, device=None) -> "GaussianDiffusion":
        betas = linear_beta_schedule(timesteps)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod))
        snr = alphas_cumprod / (1 - alphas_cumprod)

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=device)
        return GaussianDiffusion(
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1 - alphas_cumprod)),
            posterior_mean_coef2=f32(
                (1 - alphas_cumprod_prev) * np.sqrt(alphas)
                / (1 - alphas_cumprod)),
            loss_weight=f32(snr), num_timesteps=timesteps)

    @staticmethod
    def _at(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """a[t] shaped [B, 1, ...] to broadcast over a [B, ...] tensor."""
        return a[t].view((-1,) + (1,) * (ndim - 1))

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising of x_start [B, ...] to integer steps t [B]."""
        nd = x_start.dim()
        return (self._at(self.sqrt_alphas_cumprod, t, nd) * x_start
                + self._at(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        nd = x_t.dim()
        return ((self._at(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / self._at(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def q_posterior(self, x_start, x_t, t):
        """Mean, variance and clipped log variance of q(x_{t-1} | x_t, x0)."""
        nd = x_t.dim()
        mean = (self._at(self.posterior_mean_coef1, t, nd) * x_start
                + self._at(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, self._at(self.posterior_variance, t, nd),
                self._at(self.posterior_log_variance_clipped, t, nd))

    def _steps(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return torch.full((x.shape[0],), t, dtype=torch.long,
                          device=self.alphas_cumprod.device)

    def p_sample_loop(self, model_fn: Callable, x: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """Ancestral DDPM sampling from x_T = ``x`` (float32):
        ``num_timesteps`` calls of ``model_fn(x, t[B]) -> x0``. Step i (at
        t = N - 1 - i) adds ``noise[i]`` when given, else a standard normal
        draw from ``generator`` (see ``_draw``); the last step (t = 0) adds
        none."""
        img = x.float()
        for i in range(self.num_timesteps):
            t = self.num_timesteps - 1 - i
            bt = self._steps(img, t)
            mean, _, log_var = self.q_posterior(model_fn(img, bt).float(),
                                                img, bt)
            if t == 0:
                img = mean
                continue
            z = noise[i].to(img) if noise is not None else _draw(img,
                                                                  generator)
            img = mean + torch.exp(0.5 * log_var) * z
        return img

    def ddim_sample(self, model_fn: Callable, x: torch.Tensor, steps: int, *,
                    eta: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """DDIM from x_T = ``x`` (float32) over ``steps`` (time, time_next)
        pairs of ``np.linspace(-1, N - 1, steps + 1)`` (integers), one
        ``model_fn(x, t[B]) -> x0`` call a pair; the pair that reaches
        time_next < 0 returns the x0 prediction. With ``eta`` > 0 step i
        adds sigma times ``noise[i]`` when given, else a draw from
        ``generator``."""
        times = np.linspace(-1, self.num_timesteps - 1, steps + 1).astype(int)
        times = list(reversed(times.tolist()))
        img = x.float()
        ac = self.alphas_cumprod
        for i, (time, time_next) in enumerate(zip(times[:-1], times[1:])):
            bt = self._steps(img, time)
            x_start = model_fn(img, bt).float()
            if time_next < 0:
                img = x_start
                continue
            pred_noise = self.predict_noise_from_start(img, bt, x_start)
            alpha, alpha_next = ac[time], ac[time_next]
            sigma = eta * torch.sqrt((1 - alpha / alpha_next)
                                     * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
            img = x_start * torch.sqrt(alpha_next) + c * pred_noise
            if eta > 0:
                z = noise[i].to(img) if noise is not None else _draw(
                    img, generator)
                img = img + sigma * z
        return img
