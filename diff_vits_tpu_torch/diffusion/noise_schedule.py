"""Discrete VP noise schedule with piecewise-linear log-alpha tables.

Port of ``diff_vits_tpu/diffusion/noise_schedule.py``: discrete step i maps
to continuous t_i = (i + 1) / N; log(alpha_t) is interpolated linearly,
extrapolated with the outermost segments. Tables are float32 on the CPU:
the sampler uses them as scalar coefficients.
"""
from __future__ import annotations

import numpy as np
import torch


def _piecewise_linear(x, xp, yp):
    idx = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                      len(xp) - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    y0, y1 = yp[idx], yp[idx + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


class NoiseScheduleVP:
    """Discrete VP schedule."""

    def __init__(self, betas: np.ndarray):
        log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(betas,
                                                             np.float64)))
        self.total_N = len(log_alphas)
        self.T = 1.0
        self.t_array = torch.as_tensor(
            np.linspace(0, 1, self.total_N + 1)[1:], dtype=torch.float32)
        self.log_alpha_array = torch.as_tensor(log_alphas,
                                               dtype=torch.float32)

    def marginal_log_mean_coeff(self, t):
        return _piecewise_linear(torch.as_tensor(t, dtype=torch.float32),
                                 self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))
        return log_mean - log_std
