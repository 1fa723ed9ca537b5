"""UniPC multistep sampler: the serving configuration (B(h) = bh2, order 2,
time-uniform grid, lower-order final step, data prediction).

Port of ``sample_unipc`` of ``diff_vits_tpu/diffusion/uni_pc.py`` for that
configuration: the same time grid, coefficients and order schedule (one
order-1 warm-up step, order 2 after it, order 1 on the last step, no
corrector on the last step), one model evaluation per step. The JAX
package compiles the interior steps into a ``lax.scan``; here they are a
Python loop. Coefficients are float32 scalars on the CPU, as the JAX
package computes them in float32. The JAX package's other variants (bh1,
vary_coeff), order 3 and the quadratic grid are not ported.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from diff_vits_tpu_torch.diffusion.dpm_solver import (
    adapt_x0_fn, time_steps_uniform)
from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP

ORDER = 2


def sample_unipc(x0_fn: Callable, noise_schedule: NoiseScheduleVP,
                 x: torch.Tensor, steps: int = 30) -> torch.Tensor:
    """UniPC sampling from x ~ N(0, I); ``x0_fn(x, t_discrete[B])`` or
    ``x0_fn(x, t_discrete[B], step_index)`` predicts x0."""
    if steps < ORDER:
        raise ValueError(f"UniPC of order {ORDER} needs {ORDER} steps or "
                         f"more, got {steps}")
    ns = noise_schedule
    ts = time_steps_uniform(ns, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = torch.exp(ns.marginal_log_mean_coeff(ts))
    b = x.shape[0]
    fn = adapt_x0_fn(x0_fn)

    def eval_model(xv, i):
        # the solver state is float32 whatever the model computes in, as
        # in the JAX package (float32 coefficients promote a bf16 output)
        td = (ts[i] * ns.total_N - 1.0).to(xv.device).expand(b)
        return fn(xv, td, i).float()

    def step(x, ms: List[torch.Tensor], i: int, k: int, use_corrector: bool):
        """Arrival at ts[i+1] at order k (1 or 2) from models ms (newest
        first)."""
        m0 = ms[0]
        hh = lam[i] - lam[i + 1]
        h_phi_1 = torch.expm1(hh)
        B_h = h_phi_1
        x_t_ = sig[i + 1] / sig[i] * x - alp[i + 1] * h_phi_1 * m0
        x_t = x_t_
        D1 = None
        if k == 2:
            r1 = (lam[i - 1] - lam[i]) / (lam[i + 1] - lam[i])
            D1 = (ms[1] - m0) / r1
            x_t = x_t_ - alp[i + 1] * B_h * 0.5 * D1
        if not use_corrector:
            return x_t, None
        model_t = eval_model(x_t, i + 1)
        if k == 1:
            corr = 0.5 * (model_t - m0)
        else:
            # rhos_c solves R rho = b, R rows r^0 and r^1 of (r1, 1),
            # b_j = h_phi_j * j! / B_h (uni_pc.py:516-524)
            h_phi_k = h_phi_1 / hh - 1.0
            b1 = h_phi_k / B_h
            b2 = (h_phi_k / hh - 0.5) * 2.0 / B_h
            rhos_c = torch.linalg.solve(
                torch.stack([torch.stack([torch.ones(()), torch.ones(())]),
                             torch.stack([r1, torch.ones(())])]),
                torch.stack([b1, b2]))
            corr = rhos_c[0] * D1 + rhos_c[1] * (model_t - m0)
        return x_t_ - alp[i + 1] * B_h * corr, model_t

    ms = [eval_model(x, 0)]
    x, model_t = step(x, ms, 0, 1, True)
    ms = [model_t] + ms
    for s in range(ORDER, steps + 1):
        last = s == steps
        x, model_t = step(x, ms, s - 1, 1 if last else ORDER, not last)
        if not last:
            ms = [model_t] + ms[:-1]
    return x
