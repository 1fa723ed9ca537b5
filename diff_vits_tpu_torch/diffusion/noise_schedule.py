"""Discrete VP noise schedule with piecewise-linear log-alpha tables.

Port of ``diff_vits_tpu/diffusion/noise_schedule.py``: discrete step i maps
to continuous t_i = (i + 1) / N; log(alpha_t) is interpolated linearly,
extrapolated with the outermost segments; ``inverse_lambda`` maps a
half-logSNR back to t over the same tables (:48). Tables are float32 and
live on the CPU, where the samplers compute their scalar coefficients; a
copy goes to another device the first time a tensor there asks for it.
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
        self._tables = {}

    def _on(self, device: torch.device):
        """(t_array, log_alpha_array, both flipped) on ``device``; the
        flipped copies are contiguous, as ``searchsorted`` needs."""
        if device not in self._tables:
            t, la = self.t_array.to(device), self.log_alpha_array.to(device)
            self._tables[device] = (t, la, torch.flip(t, (0,)),
                                    torch.flip(la, (0,)))
        return self._tables[device]

    def marginal_log_mean_coeff(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        t_arr, la_arr, _, _ = self._on(t.device)
        return _piecewise_linear(t, t_arr, la_arr)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))
        return log_mean - log_std

    def inverse_lambda(self, lamb):
        """t whose half-logSNR is ``lamb``: log alpha = -0.5 log(1 +
        e^(-2 lamb)), then t over the tables read backwards (log alpha
        decreases with t)."""
        lamb = torch.as_tensor(lamb, dtype=torch.float32)
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb),
                                           -2.0 * lamb)
        _, _, t_flip, la_flip = self._on(lamb.device)
        return _piecewise_linear(log_alpha, la_flip, t_flip)
