"""Sampling time grids, the model-callback adapter and DPM-Solver++.

Port of ``time_steps_uniform`` (``get_time_steps`` with the time-uniform
grid, the one the serving samplers use), ``adapt_x0_fn`` and
``sample_dpmpp`` of ``diff_vits_tpu/diffusion/dpm_solver.py`` in the one
configuration ``synthesize`` uses (:171-282, 295-440): multistep, order 2,
time-uniform grid, data prediction (``dpmsolver++``), solver type
``dpmsolver``, the lower-order final step below 10 steps. The JAX
package's singlestep and adaptive methods, order 1 and 3, the logSNR and
quadratic grids, noise prediction, thresholding, ``denoise_to_zero`` and
``inverse_dpmpp`` are not ported.
"""
from __future__ import annotations

import inspect
from typing import Callable

import numpy as np
import torch

from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP


def time_steps_uniform(ns: NoiseScheduleVP, steps: int) -> torch.Tensor:
    """Sampling grid of steps+1 times, uniform from ns.T to 1/total_N,
    float32."""
    grid = np.linspace(ns.T, 1.0 / ns.total_N, steps + 1)
    return torch.as_tensor(grid, dtype=torch.float32)


def adapt_x0_fn(x0_fn: Callable) -> Callable:
    """Normalise a model callback to ``(x, t_discrete, step_index)``;
    3-argument callbacks also get the solver's grid index, with which they
    index precomputed per-step conditioning."""
    try:
        n = len(inspect.signature(x0_fn).parameters)
    except (TypeError, ValueError):
        n = 2
    if n >= 3:
        return x0_fn
    return lambda x, td, i: x0_fn(x, td)


ORDER = 2


def sample_dpmpp(x0_fn: Callable, noise_schedule: NoiseScheduleVP,
                 x: torch.Tensor, steps: int = 20) -> torch.Tensor:
    """DPM-Solver++ (multistep, order 2) from x at t = T to t = 1/N, one
    model evaluation a step; ``x0_fn(x, t_discrete[B])`` or
    ``x0_fn(x, t_discrete[B], step_index)`` predicts x0. Coefficients are
    float32 scalars on the CPU, as the JAX package computes them in
    float32; the state is float32 whatever the model computes in."""
    if steps < ORDER:
        raise ValueError(f"DPM-Solver++ of order {ORDER} needs {ORDER} steps "
                         f"or more, got {steps}")
    ns = noise_schedule
    ts = time_steps_uniform(ns, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = torch.exp(ns.marginal_log_mean_coeff(ts))
    b = x.shape[0]
    fn = adapt_x0_fn(x0_fn)

    def eval_model(xv, i):
        td = (ts[i] * ns.total_N - 1.0).to(xv.device).expand(b)
        return fn(xv, td, i).float()

    def update1(xv, m0, i):
        """First-order arrival at ts[i+1]."""
        h = lam[i + 1] - lam[i]
        return sig[i + 1] / sig[i] * xv - alp[i + 1] * torch.expm1(-h) * m0

    def update2(xv, m0, m1, i):
        """Second-order arrival at ts[i+1] from the models at ts[i] (m0)
        and ts[i-1] (m1)."""
        h = lam[i + 1] - lam[i]
        r0 = (lam[i] - lam[i - 1]) / h
        d1 = (m0 - m1) / r0
        phi_1 = torch.expm1(-h)
        return (sig[i + 1] / sig[i] * xv - alp[i + 1] * phi_1 * m0
                - 0.5 * alp[i + 1] * phi_1 * d1)

    x = x.float()
    m1 = eval_model(x, 0)
    x = update1(x, m1, 0)
    m0 = eval_model(x, 1)
    for i in range(2, steps):
        x = update2(x, m0, m1, i - 1)
        m0, m1 = eval_model(x, i), m0
    if steps < 10:      # lower_order_final
        return update1(x, m0, steps - 1)
    return update2(x, m0, m1, steps - 1)
