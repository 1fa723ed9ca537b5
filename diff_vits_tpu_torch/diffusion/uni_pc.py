"""UniPC (unified predictor-corrector) multistep sampler, every variant.

Port of ``sample_unipc`` of ``diff_vits_tpu/diffusion/uni_pc.py`` (:32-243),
whole: the variants B(h) = h (``bh1``) and B(h) = e^h - 1 (``bh2``) at
orders 1-3 with the order-k R-matrix solves of the predictor and the
corrector (:102-150), the ``vary_coeff`` variant with its C-matrix
inverses and the corrector's ``A_c[max(K-2, 0)][-1]`` indexing, kept as
the JAX package keeps it (:152-202), data and noise prediction, dynamic
thresholding or a callable ``correcting_x0_fn`` (data prediction only),
the grids of ``dpm_solver.get_time_steps``, and the step loop (:206-243):
warm-up steps at increasing order, the interior at ``order``, with
``lower_order_final`` the last steps at min(order, steps + 1 - step), no
corrector on the last step. The model value kept for the next step is the
one evaluated at the predictor's x_t; one model evaluation a step.

The JAX package compiles the interior into a ``lax.scan``; here it is a
Python loop. Coefficients (and the small solves and inverses) are float32
on the CPU, as the JAX package computes them in float32, so a step on the
card launches only the elementwise work on the state. A 3-argument
callback gets the grid index, which is the time-uniform grid's index only
on that grid (see ``dpm_solver``).
"""
from __future__ import annotations

from typing import Callable

import torch

from diff_vits_tpu_torch.diffusion.dpm_solver import (
    adapt_x0_fn, dynamic_thresholding, get_time_steps)
from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP


def sample_unipc(
    x0_fn: Callable,
    noise_schedule: NoiseScheduleVP,
    x: torch.Tensor,
    steps: int = 30,
    order: int = 2,
    variant: str = "bh2",
    skip_type: str = "time_uniform",
    lower_order_final: bool = True,
    algorithm_type: str = "data_prediction",
    correcting_x0_fn=None,
    thresholding_ratio: float = 0.995,
    thresholding_max_val: float = 1.0,
) -> torch.Tensor:
    """UniPC multistep sampling from x ~ N(0, I).

    Args:
      x0_fn: ``(x, t_discrete[B]) -> x0`` prediction, or ``(x,
        t_discrete[B], step_index)``.
      order: 1, 2 or 3.
      variant: 'bh1' | 'bh2' | 'vary_coeff'.
      skip_type: 'time_uniform' | 'logSNR' | 'time_quadratic'.
      algorithm_type: 'data_prediction' | 'noise_prediction' (the x0
        callback is converted to a noise predictor internally).
      correcting_x0_fn: None, 'dynamic_thresholding', or a callable
        applied to every x0 prediction (data_prediction only).
    """
    if not 1 <= order <= 3:
        raise ValueError("UniPC orders 1-3 supported")
    if steps < order:
        raise ValueError(f"UniPC of order {order} needs {order} steps or "
                         f"more, got {steps}")
    if variant not in ("bh1", "bh2", "vary_coeff"):
        raise ValueError(f"unsupported variant {variant!r}")
    if algorithm_type not in ("data_prediction", "noise_prediction"):
        raise ValueError(f"unsupported algorithm_type {algorithm_type!r}")
    pp = algorithm_type == "data_prediction"
    ns = noise_schedule
    ts = get_time_steps(ns, skip_type, ns.T, 1.0 / ns.total_N, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = torch.exp(ns.marginal_log_mean_coeff(ts))
    b = x.shape[0]
    base_fn = adapt_x0_fn(x0_fn)

    if correcting_x0_fn == "dynamic_thresholding":
        def correct(x0):
            return dynamic_thresholding(x0, thresholding_ratio,
                                        thresholding_max_val)
    else:
        correct = correcting_x0_fn

    def eval_model(xv, i):
        # the solver state is float32 whatever the model computes in, as
        # in the JAX package (float32 coefficients promote a bf16 output)
        td = ts[i] * ns.total_N - 1.0
        out = base_fn(xv, td.to(xv.device).expand(b), i)
        if not pp:
            # the noise prediction route: no x0 correction
            t_cont = (td + 1.0) / ns.total_N
            return ((xv - ns.marginal_alpha(t_cont) * out.float())
                    / ns.marginal_std(t_cont))
        if correct is not None:
            out = correct(out)
        return out.float()

    def common(x, ms, i, k):
        """What both variants share for the arrival at ts[i+1] at order k
        from models ``ms`` (newest first): hh, h_phi_1, the step's
        coefficient, r_k, D1_k and the first-order x_t."""
        m0 = ms[0]
        h = lam[i + 1] - lam[i]
        hh = -h if pp else h
        h_phi_1 = torch.expm1(hh)
        coeff = alp[i + 1] if pp else sig[i + 1]
        rks = torch.stack([(lam[i - j] - lam[i]) / h for j in range(1, k)]
                          + [torch.ones((), dtype=torch.float32)])
        D1s = [(ms[j] - m0) / rks[j - 1] for j in range(1, k)]
        x_t_ = (sig[i + 1] / sig[i] * x - alp[i + 1] * h_phi_1 * m0 if pp
                else alp[i + 1] / alp[i] * x - sig[i + 1] * h_phi_1 * m0)
        return hh, h_phi_1, coeff, rks, D1s, x_t_

    def step_bh(x, ms, i, k, use_corrector):
        """bh1 / bh2 arrival at ts[i+1] at order k; returns (x_t, the model
        at the predictor's x_t or None)."""
        hh, h_phi_1, coeff, rks, D1s, x_t_ = common(x, ms, i, k)
        B_h = hh if variant == "bh1" else torch.expm1(hh)
        # R rows r^(j-1), b_j = h_phi_(j+1) j! / B_h
        rows, bs = [], []
        h_phi_k = h_phi_1 / hh - 1.0
        factorial_i = 1
        for j in range(1, k + 1):
            rows.append(rks ** (j - 1))
            bs.append(h_phi_k * factorial_i / B_h)
            factorial_i *= j + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        R = torch.stack(rows)
        bvec = torch.stack(bs)
        x_t = x_t_
        if k >= 2:
            if k == 2:
                rhos_p = [0.5]
            else:
                rhos_p = torch.linalg.solve(R[:-1, :-1], bvec[:-1])
            pred_res = sum(rhos_p[j] * D1s[j] for j in range(k - 1))
            x_t = x_t_ - coeff * B_h * pred_res
        if not use_corrector:
            return x_t, None
        rhos_c = [0.5] if k == 1 else torch.linalg.solve(R, bvec)
        model_t = eval_model(x_t, i + 1)
        D1_t = model_t - ms[0]
        corr_res = sum(rhos_c[j] * D1s[j] for j in range(k - 1))
        return x_t_ - coeff * B_h * (corr_res + rhos_c[k - 1] * D1_t), model_t

    def step_vary(x, ms, i, k, use_corrector):
        """vary_coeff arrival at ts[i+1] at order k."""
        hh, h_phi_1, coeff, rks, D1s, x_t_ = common(x, ms, i, k)
        # C[:, j] = rks^j / (j+1)!
        cols, col = [], torch.ones_like(rks)
        for j in range(1, k + 1):
            cols.append(col)
            col = col * rks / (j + 1)
        C = torch.stack(cols, dim=1)
        # h_phi_ks: h_phi_1, h_phi_1 / hh - 1, ... / hh - 1/2!, ...
        h_phi_ks, h_phi_k, factorial_j = [], h_phi_1, 1
        for j in range(1, k + 2):
            h_phi_ks.append(h_phi_k)
            h_phi_k = h_phi_k / hh - 1.0 / factorial_j
            factorial_j *= j + 1
        x_t = x_t_
        if k >= 2:
            A_p = torch.linalg.inv(C[:-1, :-1])
            for j in range(k - 1):
                res = sum(A_p[j, l] * D1s[l] for l in range(k - 1))
                x_t = x_t - coeff * h_phi_ks[j + 1] * res
        if not use_corrector:
            return x_t, None
        A_c = torch.linalg.inv(C)
        model_t = eval_model(x_t, i + 1)
        D1_t = model_t - ms[0]
        x_t = x_t_
        for j in range(k - 1):
            res = sum(A_c[j, l] * D1s[l] for l in range(k - 1))
            x_t = x_t - coeff * h_phi_ks[j + 1] * res
        # A_c[max(K-2, 0)][-1], not A_c[-1][-1]: the reference indexes by
        # its loop variable's last value, and so does the JAX package
        jlast = max(k - 2, 0)
        x_t = x_t - coeff * h_phi_ks[k] * (A_c[jlast, -1] * D1_t)
        return x_t, model_t

    step = step_vary if variant == "vary_coeff" else step_bh

    # the model at x_T; warm-up arrivals ts[1..order-1] at increasing order
    ms = [eval_model(x, 0)]
    for w in range(1, order):
        x, model_t = step(x, ms, w - 1, w, True)
        ms = [model_t] + ms
    # arrivals ts[order..steps]; no corrector on the last
    for s in range(order, steps + 1):
        k = min(order, steps + 1 - s) if lower_order_final else order
        use_c = s < steps
        x, model_t = step(x, ms, s - 1, k, use_c)
        if use_c:
            ms = [model_t] + ms[:-1]
    return x
