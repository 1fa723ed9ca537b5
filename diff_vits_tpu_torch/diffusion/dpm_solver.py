"""DPM-Solver / DPM-Solver++ sampler library: time grids, the model
wrappers and every solver method.

Port of ``diff_vits_tpu/diffusion/dpm_solver.py``, whole:

- ``get_time_steps`` (:39), the time-uniform, logSNR and time-quadratic
  grids; ``time_steps_uniform`` (:55) is the grid ``synthesize`` uses;
- ``dynamic_thresholding`` (:59), ``adapt_x0_fn`` (:70);
- ``wrap_model`` (:85): noise / x_start / v / score models, unconditional,
  classifier and classifier-free guidance, converted to the x0 callback
  the solvers take;
- ``sample_dpmpp`` (:171) with the JAX signature and defaults: multistep
  orders 1-3 with ``lower_order_final`` (:295-434), singlestep and
  singlestep_fixed orders 1-3 (:551-584, the order schedule of
  ``_singlestep_orders`` :153), the adaptive solver (:587-637), the
  ``dpmsolver`` and ``taylor`` updates, data prediction (``dpmsolver++``)
  and noise prediction (``dpmsolver``, no x0 correction), ``t_start`` /
  ``t_end``, ``correcting_x0_fn`` and ``denoise_to_zero``; the singlestep
  updates ``_single_update1/2/3`` (:442-548);
- ``inverse_dpmpp`` (:285).

The JAX package compiles the interior steps into ``lax.scan`` and the
adaptive solver into ``lax.while_loop``; here both are Python loops. The
adaptive loop reads its error norm and its stopping test on the host, one
device sync an iteration. Step coefficients are float32 scalars on the
CPU, as the JAX package computes them in float32, so a step on the card
launches only the elementwise work on the state; the state is float32
whatever the model computes in.

The step index: a 3-argument callback ``(x, t_discrete, step_index)`` also
gets an index, with which ``synthesize`` picks precomputed per-step
embeddings of the time-uniform grid. The index is that grid's only on the
multistep method over the time-uniform grid: singlestep passes its outer
step index to its inner evaluations and the adaptive solver passes 0, as
the JAX package does. Drive any other setting with a 2-argument callback.
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP


def _f32(v) -> torch.Tensor:
    """A float32 CPU scalar, as JAX turns a Python float into float32."""
    return torch.as_tensor(v, dtype=torch.float32)


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                   t_0: float, N: int) -> torch.Tensor:
    """Sampling grid of N+1 float32 times from t_T to t_0."""
    if skip_type == "time_uniform":
        return torch.as_tensor(np.linspace(t_T, t_0, N + 1),
                               dtype=torch.float32)
    if skip_type == "logSNR":
        lam_T = ns.marginal_lambda(_f32(t_T))
        lam_0 = ns.marginal_lambda(_f32(t_0))
        lams = torch.linspace(float(lam_T), float(lam_0), N + 1,
                              dtype=torch.float32)
        return ns.inverse_lambda(lams)
    if skip_type == "time_quadratic":
        return torch.as_tensor(
            np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2,
            dtype=torch.float32)
    raise ValueError(f"unsupported skip_type {skip_type!r}")


def time_steps_uniform(ns: NoiseScheduleVP, steps: int) -> torch.Tensor:
    """Sampling grid of steps+1 times, uniform from ns.T to 1/total_N,
    float32."""
    return get_time_steps(ns, "time_uniform", ns.T, 1.0 / ns.total_N, steps)


def dynamic_thresholding(x0: torch.Tensor, ratio: float = 0.995,
                         max_val: float = 1.0) -> torch.Tensor:
    """Imagen-style per-sample percentile clamp of the x0 prediction; the
    quantile interpolates linearly, as ``jnp.quantile`` does."""
    b = x0.shape[0]
    s = torch.quantile(x0.abs().reshape(b, -1).float(), ratio, dim=1)
    s = s.clamp_min(max_val).reshape((b,) + (1,) * (x0.ndim - 1))
    return (torch.clamp(x0, -s, s) / s).to(x0.dtype)


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


def wrap_model(model: Callable, noise_schedule: NoiseScheduleVP,
               model_type: str = "x_start", guidance_type: str = "uncond",
               condition=None, unconditional_condition=None,
               guidance_scale: float = 1.0,
               classifier_fn: Optional[Callable] = None) -> Callable:
    """Convert a noise / x_start / v / score model (and its guidance) into
    the x0 callback ``(x, t_discrete) -> x0`` the solvers take; guidance
    is applied in noise space, then converted to x0. The model is called
    as ``model(x, t_discrete)``, with classifier-free guidance as
    ``model(x, t_discrete, cond)``.

    Classifier guidance differentiates ``classifier_fn(x, t_discrete,
    condition).sum()`` with respect to x by autograd, so its callback must
    run outside ``torch.inference_mode()`` (``synthesize`` runs inside
    it); gradients are taken whatever ``torch.no_grad`` says."""
    ns = noise_schedule

    def expand(a, nd):
        return a.reshape((-1,) + (1,) * (nd - 1))

    def to_noise(out, x, t_cont):
        nd = x.ndim
        if model_type == "noise":
            return out
        alpha = expand(ns.marginal_alpha(t_cont), nd)
        sigma = expand(ns.marginal_std(t_cont), nd)
        if model_type == "x_start":
            return (x - alpha * out) / sigma
        if model_type == "v":
            return alpha * out + sigma * x
        if model_type == "score":
            return -sigma * out
        raise ValueError(f"unsupported model_type {model_type!r}")

    def noise_to_x0(noise, x, t_cont):
        nd = x.ndim
        alpha = expand(ns.marginal_alpha(t_cont), nd)
        sigma = expand(ns.marginal_std(t_cont), nd)
        return (x - sigma * noise) / alpha

    def x0_fn(x, t_discrete):
        t_cont = (t_discrete + 1.0) / ns.total_N
        if guidance_type == "uncond":
            out = model(x, t_discrete)
            if model_type == "x_start":
                return out
            return noise_to_x0(to_noise(out, x, t_cont), x, t_cont)
        if guidance_type == "classifier":
            if classifier_fn is None:
                raise ValueError("classifier guidance requires classifier_fn")
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                grad, = torch.autograd.grad(
                    classifier_fn(xx, t_discrete, condition).sum(), xx)
            noise = to_noise(model(x, t_discrete), x, t_cont)
            sigma = expand(ns.marginal_std(t_cont), x.ndim)
            return noise_to_x0(noise - guidance_scale * sigma * grad,
                               x, t_cont)
        if guidance_type == "classifier-free":
            if guidance_scale == 1.0 or unconditional_condition is None:
                noise = to_noise(model(x, t_discrete, condition), x, t_cont)
                return noise_to_x0(noise, x, t_cont)
            n_c = to_noise(model(x, t_discrete, condition), x, t_cont)
            n_u = to_noise(model(x, t_discrete, unconditional_condition),
                           x, t_cont)
            guided = n_u + guidance_scale * (n_c - n_u)
            return noise_to_x0(guided, x, t_cont)
        raise ValueError(f"unsupported guidance_type {guidance_type!r}")

    return x0_fn


def _singlestep_orders(steps: int, order: int):
    """DPM-Solver-fast order schedule: orders of the outer steps, summing
    to ``steps`` model evaluations."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    if order == 1:
        return [1] * steps
    raise ValueError("order must be 1, 2 or 3")


def sample_dpmpp(
    x0_fn: Callable,
    noise_schedule: NoiseScheduleVP,
    x: torch.Tensor,
    steps: int = 20,
    order: int = 2,
    lower_order_final: bool = True,
    skip_type: str = "time_uniform",
    method: str = "multistep",
    solver_type: str = "dpmsolver",
    algorithm_type: str = "dpmsolver++",
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    correcting_x0_fn: Optional[object] = None,
    thresholding_ratio: float = 0.995,
    thresholding_max_val: float = 1.0,
    denoise_to_zero: bool = False,
    atol: float = 0.0078,
    rtol: float = 0.05,
    h_init: float = 0.05,
    theta: float = 0.9,
    t_err: float = 1e-5,
) -> torch.Tensor:
    """DPM-Solver / DPM-Solver++ from x at t_start (default T).

    Args:
      x0_fn: ``(x, t_discrete[B]) -> x0`` prediction (the diffusion model),
        or ``(x, t_discrete[B], step_index)`` (see the module docstring).
      steps: number of model evaluations (ignored by method='adaptive').
      order: 1, 2 or 3 (adaptive: 2 or 3).
      skip_type: 'time_uniform' | 'logSNR' | 'time_quadratic'.
      method: 'multistep' | 'singlestep' | 'singlestep_fixed' | 'adaptive'.
      solver_type: 'dpmsolver' | 'taylor', the order >= 2 update.
      algorithm_type: 'dpmsolver++' (data prediction) | 'dpmsolver'
        (noise prediction; the x0 callback is converted internally).
      t_start/t_end: solve interval (defaults T -> 1/N; swap to invert).
      correcting_x0_fn: None, 'dynamic_thresholding', or a callable
        ``x0 -> x0`` applied to every x0 prediction (dpmsolver++ only).
      denoise_to_zero: one more x0 evaluation at t_end after the last step.
      atol/rtol/h_init/theta/t_err: the adaptive solver's controls.
    """
    ns = noise_schedule
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    b = x.shape[0]
    base_fn = adapt_x0_fn(x0_fn)
    if solver_type not in ("dpmsolver", "taylor"):
        raise ValueError("solver_type must be 'dpmsolver' or 'taylor'")
    if algorithm_type not in ("dpmsolver++", "dpmsolver"):
        raise ValueError(
            "algorithm_type must be 'dpmsolver++' or 'dpmsolver'")
    if method == "multistep":
        if order not in (1, 2, 3):
            raise ValueError("order must be 1, 2 or 3")
        if steps < order:
            raise ValueError(f"DPM-Solver++ of order {order} needs {order} "
                             f"steps or more, got {steps}")
    elif method == "adaptive":
        if order not in (2, 3):
            raise ValueError("adaptive solver supports order 2 or 3")
    elif method not in ("singlestep", "singlestep_fixed"):
        raise ValueError(f"unsupported method {method!r}")
    pp = algorithm_type == "dpmsolver++"

    if correcting_x0_fn == "dynamic_thresholding":
        def correct(x0):
            return dynamic_thresholding(x0, thresholding_ratio,
                                        thresholding_max_val)
    else:
        correct = correcting_x0_fn

    def model_out(xv, t, i):
        """The callback at continuous time t (a float32 CPU scalar),
        t_discrete = t N - 1 for every item, and t_discrete itself."""
        td = t * ns.total_N - 1.0
        return base_fn(xv, td.to(xv.device).expand(b), i), td

    def x0_pred(xv, t, i):
        out, _ = model_out(xv, t, i)
        if correct is not None:
            out = correct(out)
        return out.float()

    if pp:
        fn = x0_pred
    else:
        # the noise prediction route: no x0 correction
        def fn(xv, t, i):
            x0, td = model_out(xv, t, i)
            t_cont = (td + 1.0) / ns.total_N
            return ((xv - ns.marginal_alpha(t_cont) * x0.float())
                    / ns.marginal_std(t_cont))

    x = x.float()
    if method == "multistep":
        x = _sample_multistep(fn, ns, x, steps, order, lower_order_final,
                              skip_type, solver_type, pp, t_T, t_0)
        last_i = steps
    elif method in ("singlestep", "singlestep_fixed"):
        if method == "singlestep_fixed":
            orders = [order] * (steps // order)
            ts_outer = get_time_steps(ns, skip_type, t_T, t_0, len(orders))
        else:
            orders = _singlestep_orders(steps, order)
            if skip_type == "logSNR":
                ts_outer = get_time_steps(ns, skip_type, t_T, t_0,
                                          len(orders))
            else:
                full = get_time_steps(ns, skip_type, t_T, t_0, steps)
                ts_outer = full[np.cumsum([0] + orders)]
        x = _sample_singlestep(fn, ns, x, ts_outer, orders, solver_type,
                               skip_type, pp)
        last_i = len(orders)
    else:
        x = _sample_adaptive(fn, ns, x, order, t_T, t_0, h_init, atol,
                             rtol, theta, t_err, solver_type, pp)
        last_i = 0

    if denoise_to_zero:
        x = x0_pred(x, _f32(t_0), last_i)
    return x


def inverse_dpmpp(x0_fn: Callable, noise_schedule: NoiseScheduleVP,
                  x: torch.Tensor, steps: int = 20, **kwargs) -> torch.Tensor:
    """Invert a sample from t = 1/N towards t = T: ``sample_dpmpp`` with
    the solve interval reversed."""
    ns = noise_schedule
    t_0 = kwargs.pop("t_start", 1.0 / ns.total_N)
    t_T = kwargs.pop("t_end", ns.T)
    return sample_dpmpp(x0_fn, noise_schedule, x, steps=steps,
                        t_start=t_0, t_end=t_T, **kwargs)


def _sample_multistep(fn, ns, x, steps, order, lower_order_final, skip_type,
                      solver_type, pp, t_T, t_0):
    """Multistep orders 1-3: a warm-up at increasing order, the interior
    at ``order``, and with ``lower_order_final`` below 10 steps the last
    arrivals at decreasing order; one model evaluation a step."""
    ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = torch.exp(ns.marginal_log_mean_coeff(ts))

    def eval_model(xv, i):
        return fn(xv, ts[i], i)

    def update1(xv, m0, i):
        """First-order arrival at ts[i+1]."""
        h = lam[i + 1] - lam[i]
        if pp:
            return sig[i + 1] / sig[i] * xv - alp[i + 1] * torch.expm1(-h) * m0
        return alp[i + 1] / alp[i] * xv - sig[i + 1] * torch.expm1(h) * m0

    def update2(xv, m0, m1, i):
        """Second-order arrival at ts[i+1] from the models at ts[i] (m0)
        and ts[i-1] (m1)."""
        h = lam[i + 1] - lam[i]
        r0 = (lam[i] - lam[i - 1]) / h
        D1_0 = (m0 - m1) / r0
        if pp:
            phi_1 = torch.expm1(-h)
            base = sig[i + 1] / sig[i] * xv - alp[i + 1] * phi_1 * m0
            if solver_type == "dpmsolver":
                return base - 0.5 * alp[i + 1] * phi_1 * D1_0
            return base + alp[i + 1] * (phi_1 / h + 1.0) * D1_0
        phi_1 = torch.expm1(h)
        base = alp[i + 1] / alp[i] * xv - sig[i + 1] * phi_1 * m0
        if solver_type == "dpmsolver":
            return base - 0.5 * sig[i + 1] * phi_1 * D1_0
        return base - sig[i + 1] * (phi_1 / h - 1.0) * D1_0

    def update3(xv, m0, m1, m2, i):
        """Third-order arrival at ts[i+1] from the models at ts[i],
        ts[i-1] and ts[i-2]."""
        h = lam[i + 1] - lam[i]
        h_0 = lam[i] - lam[i - 1]
        h_1 = lam[i - 1] - lam[i - 2]
        r0, r1 = h_0 / h, h_1 / h
        D1_0 = (m0 - m1) / r0
        D1_1 = (m1 - m2) / r1
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (D1_0 - D1_1) / (r0 + r1)
        if pp:
            phi_1 = torch.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return (sig[i + 1] / sig[i] * xv
                    - alp[i + 1] * phi_1 * m0
                    + alp[i + 1] * phi_2 * D1
                    - alp[i + 1] * phi_3 * D2)
        phi_1 = torch.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return (alp[i + 1] / alp[i] * xv
                - sig[i + 1] * phi_1 * m0
                - sig[i + 1] * phi_2 * D1
                - sig[i + 1] * phi_3 * D2)

    m1 = eval_model(x, 0)
    x = update1(x, m1, 0)
    if order == 1:
        for i in range(1, steps):
            x = update1(x, eval_model(x, i), i)
        return x

    m0 = eval_model(x, 1)
    if order == 2:
        for i in range(2, steps):
            x = update2(x, m0, m1, i - 1)
            m0, m1 = eval_model(x, i), m0
        if lower_order_final and steps < 10:
            return update1(x, m0, steps - 1)
        return update2(x, m0, m1, steps - 1)

    # order 3: arrivals at ts[3..steps]; with `lower` the last two drop
    # to orders 2 and 1
    x = update2(x, m0, m1, 1)
    m2, m1, m0 = m1, m0, eval_model(x, 2)
    lower = lower_order_final and steps < 10
    n_full = (steps - 3) if not lower else max(steps - 4, 0)
    for i in range(3, 3 + n_full):
        x = update3(x, m0, m1, m2, i - 1)
        m2, m1, m0 = m1, m0, eval_model(x, i)
    if not lower:
        return update3(x, m0, m1, m2, steps - 1)
    i = 3 + n_full      # the first grid point not arrived at
    if steps + 1 - i == 2:
        x = update2(x, m0, m1, i - 1)
        m0 = eval_model(x, i)
        i += 1
    return update1(x, m0, i - 1)


# -- singlestep updates, shared by the singlestep loop and the adaptive
# solver; s and t are float32 CPU scalars (or Python floats)

def _coeffs(ns, t):
    lam = ns.marginal_lambda(t)
    log_alp = ns.marginal_log_mean_coeff(t)
    sig = ns.marginal_std(t)
    return lam, torch.exp(log_alp), sig, log_alp


def _single_update1(ns, x, s, t, m_s, pp):
    """DPM-Solver-1 (DDIM) step from s to t."""
    lam_s, alp_s, sig_s, loga_s = _coeffs(ns, s)
    lam_t, alp_t, sig_t, loga_t = _coeffs(ns, t)
    h = lam_t - lam_s
    if pp:
        return sig_t / sig_s * x - alp_t * torch.expm1(-h) * m_s
    return torch.exp(loga_t - loga_s) * x - sig_t * torch.expm1(h) * m_s


def _single_update2(eval_fn, ns, x, s, t, r1, m_s, solver_type, pp):
    """Singlestep second-order update from s to t with one evaluation at
    s1 = inverse_lambda(lam_s + r1 h); returns (x_t, m_s1)."""
    lam_s, alp_s, sig_s, loga_s = _coeffs(ns, s)
    lam_t, alp_t, sig_t, loga_t = _coeffs(ns, t)
    h = lam_t - lam_s
    lam_s1 = lam_s + r1 * h
    s1 = ns.inverse_lambda(lam_s1)
    _, alp_s1, sig_s1, loga_s1 = _coeffs(ns, s1)
    if pp:
        phi_11 = torch.expm1(-r1 * h)
        phi_1 = torch.expm1(-h)
        x_s1 = sig_s1 / sig_s * x - alp_s1 * phi_11 * m_s
        m_s1 = eval_fn(x_s1, s1)
        base = sig_t / sig_s * x - alp_t * phi_1 * m_s
        if solver_type == "dpmsolver":
            x_t = base - (0.5 / r1) * alp_t * phi_1 * (m_s1 - m_s)
        else:
            x_t = base + (1.0 / r1) * alp_t * (phi_1 / h + 1.0) * (
                m_s1 - m_s)
        return x_t, m_s1
    phi_11 = torch.expm1(r1 * h)
    phi_1 = torch.expm1(h)
    x_s1 = torch.exp(loga_s1 - loga_s) * x - sig_s1 * phi_11 * m_s
    m_s1 = eval_fn(x_s1, s1)
    base = torch.exp(loga_t - loga_s) * x - sig_t * phi_1 * m_s
    if solver_type == "dpmsolver":
        x_t = base - (0.5 / r1) * sig_t * phi_1 * (m_s1 - m_s)
    else:
        x_t = base - (1.0 / r1) * sig_t * (phi_1 / h - 1.0) * (m_s1 - m_s)
    return x_t, m_s1


def _single_update3(eval_fn, ns, x, s, t, r1, r2, m_s, m_s1, solver_type,
                    pp):
    """Singlestep third-order update from s to t; ``m_s1`` may be None
    (then evaluated at s1 = inverse_lambda(lam_s + r1 h)). Returns (x_t,
    m_s1, m_s2)."""
    lam_s, alp_s, sig_s, loga_s = _coeffs(ns, s)
    lam_t, alp_t, sig_t, loga_t = _coeffs(ns, t)
    h = lam_t - lam_s
    lam_s1, lam_s2 = lam_s + r1 * h, lam_s + r2 * h
    s1, s2 = ns.inverse_lambda(lam_s1), ns.inverse_lambda(lam_s2)
    _, alp_s1, sig_s1, loga_s1 = _coeffs(ns, s1)
    _, alp_s2, sig_s2, loga_s2 = _coeffs(ns, s2)
    if pp:
        phi_11 = torch.expm1(-r1 * h)
        phi_12 = torch.expm1(-r2 * h)
        phi_1 = torch.expm1(-h)
        phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        if m_s1 is None:
            x_s1 = sig_s1 / sig_s * x - alp_s1 * phi_11 * m_s
            m_s1 = eval_fn(x_s1, s1)
        x_s2 = (sig_s2 / sig_s * x - alp_s2 * phi_12 * m_s
                + (r2 / r1) * alp_s2 * phi_22 * (m_s1 - m_s))
        m_s2 = eval_fn(x_s2, s2)
        base = sig_t / sig_s * x - alp_t * phi_1 * m_s
        if solver_type == "dpmsolver":
            x_t = base + (1.0 / r2) * alp_t * phi_2 * (m_s2 - m_s)
        else:
            D1_0 = (m_s1 - m_s) / r1
            D1_1 = (m_s2 - m_s) / r2
            D1 = (r2 * D1_0 - r1 * D1_1) / (r2 - r1)
            D2 = 2.0 * (D1_1 - D1_0) / (r2 - r1)
            x_t = base + alp_t * phi_2 * D1 - alp_t * phi_3 * D2
        return x_t, m_s1, m_s2
    phi_11 = torch.expm1(r1 * h)
    phi_12 = torch.expm1(r2 * h)
    phi_1 = torch.expm1(h)
    phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
    phi_2 = phi_1 / h - 1.0
    phi_3 = phi_2 / h - 0.5
    if m_s1 is None:
        x_s1 = torch.exp(loga_s1 - loga_s) * x - sig_s1 * phi_11 * m_s
        m_s1 = eval_fn(x_s1, s1)
    x_s2 = (torch.exp(loga_s2 - loga_s) * x - sig_s2 * phi_12 * m_s
            - (r2 / r1) * sig_s2 * phi_22 * (m_s1 - m_s))
    m_s2 = eval_fn(x_s2, s2)
    base = torch.exp(loga_t - loga_s) * x - sig_t * phi_1 * m_s
    if solver_type == "dpmsolver":
        x_t = base - (1.0 / r2) * sig_t * phi_2 * (m_s2 - m_s)
    else:
        D1_0 = (m_s1 - m_s) / r1
        D1_1 = (m_s2 - m_s) / r2
        D1 = (r2 * D1_0 - r1 * D1_1) / (r2 - r1)
        D2 = 2.0 * (D1_1 - D1_0) / (r2 - r1)
        x_t = base - sig_t * phi_2 * D1 - sig_t * phi_3 * D2
    return x_t, m_s1, m_s2


def _sample_singlestep(fn, ns, x, ts_outer, orders, solver_type, skip_type,
                       pp):
    """Singlestep loop: outer step k of order ``orders[k]`` from
    ts_outer[k] to ts_outer[k+1], its inner times from the same grid
    type; the inner evaluations get the outer step index."""
    ts_outer = ts_outer.float()

    def make_eval(i):
        return lambda xv, t: fn(xv, _f32(t), i)

    for step, order in enumerate(orders):
        s, t = float(ts_outer[step]), float(ts_outer[step + 1])
        eval_fn = make_eval(step)
        m_s = eval_fn(x, s)
        if order == 1:
            x = _single_update1(ns, x, s, t, m_s, pp)
            continue
        # r1 / r2 from the inner grid of the chosen skip_type
        lam_in = ns.marginal_lambda(get_time_steps(ns, skip_type, s, t,
                                                   order))
        h_full = lam_in[-1] - lam_in[0]
        r1 = float((lam_in[1] - lam_in[0]) / h_full)
        if order == 2:
            x, _ = _single_update2(eval_fn, ns, x, s, t, r1, m_s,
                                   solver_type, pp)
            continue
        r2 = float((lam_in[2] - lam_in[0]) / h_full)
        x, _, _ = _single_update3(eval_fn, ns, x, s, t, r1, r2, m_s, None,
                                  solver_type, pp)
    return x


def _sample_adaptive(fn, ns, x, order, t_T, t_0, h_init, atol, rtol, theta,
                     t_err, solver_type, pp):
    """Adaptive step-size solver: an embedded lower / higher singlestep
    pair, the step accepted when the scaled error E <= 1, the next logSNR
    step min(theta h E^(-1/order), lambda_0 - lambda_s). E and the
    stopping test come to the host once an iteration."""
    b = x.shape[0]

    def eval_fn(xv, t):
        return fn(xv, _f32(t), 0)

    lam_0 = ns.marginal_lambda(_f32(t_0))
    x_prev, s, h = x, _f32(t_T), _f32(h_init)
    while bool(torch.abs(s - t_0) > t_err):
        lam_s = ns.marginal_lambda(s)
        t = ns.inverse_lambda(lam_s + h)
        m_s = eval_fn(x, s)
        if order == 2:
            x_lower = _single_update1(ns, x, s, t, m_s, pp)
            x_higher, _ = _single_update2(eval_fn, ns, x, s, t, 0.5, m_s,
                                          solver_type, pp)
        else:
            x_lower, m_s1 = _single_update2(eval_fn, ns, x, s, t, 1.0 / 3.0,
                                            m_s, solver_type, pp)
            x_higher, _, _ = _single_update3(
                eval_fn, ns, x, s, t, 1.0 / 3.0, 2.0 / 3.0, m_s, m_s1,
                solver_type, pp)
        delta = torch.clamp_min(
            rtol * torch.maximum(x_lower.abs(), x_prev.abs()), atol)
        err = ((x_higher - x_lower) / delta).reshape(b, -1)
        E = torch.sqrt(torch.mean(err * err, dim=-1)).max().cpu()
        if bool(E <= 1.0):
            x, x_prev, s = x_higher, x_lower, t
        h = torch.minimum(theta * h * E ** (-1.0 / order),
                          lam_0 - ns.marginal_lambda(s))
    return x
