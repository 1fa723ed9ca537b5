"""The diffusion schedule and 30-step UniPC of the reference: the discrete
VP schedule of the linear betas, the time-uniform grid, and UniPC's bh2
variant at order 2 with data prediction and lower-order final steps, the
setting the serving path samples with. Copied from the port; the solver's
coefficients are float32 on the CPU, one model evaluation a step."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


def _piecewise_linear(x, xp, yp):
    idx = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                      len(xp) - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    y0, y1 = yp[idx], yp[idx + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


class NoiseScheduleVP:
    """Discrete VP schedule over ``len(betas)`` steps."""

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
        t = torch.as_tensor(t, dtype=torch.float32)
        return _piecewise_linear(t, self.t_array, self.log_alpha_array)

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))


def time_steps_uniform(ns: NoiseScheduleVP, steps: int) -> torch.Tensor:
    """steps + 1 float32 times, uniform from ns.T to 1 / total_N."""
    return torch.as_tensor(np.linspace(ns.T, 1.0 / ns.total_N, steps + 1),
                           dtype=torch.float32)


def sample_unipc(x0_fn: Callable, ns: NoiseScheduleVP, x: torch.Tensor,
                 steps: int = 30) -> torch.Tensor:
    """UniPC bh2, order 2: ``x0_fn(x, t_discrete [B], step_index)``."""
    order = 2
    ts = time_steps_uniform(ns, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = torch.exp(ns.marginal_log_mean_coeff(ts))
    b = x.shape[0]

    def eval_model(xv, i):
        td = ts[i] * ns.total_N - 1.0
        return x0_fn(xv, td.to(xv.device).expand(b), i).float()

    def step(x, ms, i, k, use_corrector):
        m0 = ms[0]
        h = lam[i + 1] - lam[i]
        hh = -h
        h_phi_1 = torch.expm1(hh)
        coeff = alp[i + 1]
        rks = torch.stack([(lam[i - j] - lam[i]) / h for j in range(1, k)]
                          + [torch.ones((), dtype=torch.float32)])
        D1s = [(ms[j] - m0) / rks[j - 1] for j in range(1, k)]
        x_t_ = sig[i + 1] / sig[i] * x - alp[i + 1] * h_phi_1 * m0
        B_h = torch.expm1(hh)
        rows, bs = [], []
        h_phi_k = h_phi_1 / hh - 1.0
        factorial_i = 1
        for j in range(1, k + 1):
            rows.append(rks ** (j - 1))
            bs.append(h_phi_k * factorial_i / B_h)
            factorial_i *= j + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        R, bvec = torch.stack(rows), torch.stack(bs)
        x_t = x_t_
        if k >= 2:
            pred_res = sum(0.5 * D1s[j] for j in range(k - 1))
            x_t = x_t_ - coeff * B_h * pred_res
        if not use_corrector:
            return x_t, None
        rhos_c = [0.5] if k == 1 else torch.linalg.solve(R, bvec)
        model_t = eval_model(x_t, i + 1)
        D1_t = model_t - ms[0]
        corr_res = sum(rhos_c[j] * D1s[j] for j in range(k - 1))
        return x_t_ - coeff * B_h * (corr_res + rhos_c[k - 1] * D1_t), model_t

    ms = [eval_model(x, 0)]
    x, model_t = step(x, ms, 0, 1, True)
    ms = [model_t] + ms
    for s in range(order, steps + 1):
        k = min(order, steps + 1 - s)
        use_c = s < steps
        x, model_t = step(x, ms, s - 1, k, use_c)
        if use_c:
            ms = [model_t] + ms[:-1]
    return x
