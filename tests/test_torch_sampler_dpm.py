"""The port's DPM-Solver library against the JAX package's, with the same
analytic x0 model in both: the time grids, ``inverse_lambda``, every
method, order, update and algorithm of ``sample_dpmpp``, the x0
corrections, ``denoise_to_zero``, ``t_start`` / ``t_end``,
``inverse_dpmpp``, the adaptive solver, ``wrap_model``'s model types and
guidance, and the errors. Gate: atol 1e-5 on the fixed grids, 1e-4 for the
adaptive solver, and the same number of model evaluations. The JAX
samplers run under ``jax.jit`` where they can, eagerly where they convert
traced values to numpy (singlestep)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.diffusion import dpm_solver as jdpm
from diff_vits_tpu_torch.diffusion import dpm_solver as tdpm
from test_torch_sampler import _schedules

torch.set_num_threads(2)

SHAPE = (3, 17, 5)


def _toy(scale, calls, gauss=False):
    """The same x0 model in both packages, counting its evaluations; it
    reads the step index, so the index each method passes is held too.
    ``gauss``: the exact x0 of data ~ N(0, S2) (``_gauss``), whose
    inversion stays O(1); else ``scale`` tanh(x)."""
    ns, jns = _schedules()
    g_port, g_jax = _gauss("x_start", ns, torch), _gauss("x_start", jns, jnp)

    def port(x, td, i):
        calls["port"] += 1
        out = g_port(x, td) if gauss else scale * torch.tanh(x)
        return out + 1e-4 * td[:, None, None] + 0.01 * i

    def ref(x, td, i):
        jax.debug.callback(lambda: calls.__setitem__("jax",
                                                     calls["jax"] + 1))
        out = g_jax(x, td) if gauss else scale * jnp.tanh(x)
        return out + 1e-4 * td[:, None, None] + 0.01 * i
    return port, ref


S2 = 0.25   # the variance of _gauss's data


def _gauss(kind, ns, xp):
    """A 2-argument model of output type ``kind`` for data ~ N(0, S2): the
    exact prediction at t = (td + 1) / N through ``ns``, plus 1e-3
    tanh(x); ``xp`` is torch or jax.numpy."""
    def model(x, td):
        t = (td + 1.0) / ns.total_N
        a = ns.marginal_alpha(t)[:, None, None]
        s = ns.marginal_std(t)[:, None, None]
        d = a * a * S2 + s * s
        x0, eps = a * S2 * x / d, s * x / d
        out = {"x_start": x0, "noise": eps, "v": a * eps - s * x0,
               "score": -x / d}[kind]
        return out + 1e-3 * xp.tanh(x)
    return model


def _compare(kw, *, port_kw=None, jax_kw=None, scale=0.8, atol=1e-5,
             seed=0, sampler="sample_dpmpp", x=None, gauss=False):
    """One ``sampler`` call of each package on the same x (a seeded normal
    draw unless given); returns (port, jax, calls) after holding them
    within ``atol`` with equal evaluations."""
    ns, jns = _schedules()
    if x is None:
        x = np.random.default_rng(seed).normal(size=SHAPE).astype(
            np.float32)
    calls = {"port": 0, "jax": 0}
    port_fn, jax_fn = _toy(scale, calls, gauss)
    port = getattr(tdpm, sampler)(port_fn, ns, torch.from_numpy(x),
                                  **kw, **(port_kw or {}))

    def run(xj):
        return getattr(jdpm, sampler)(jax_fn, jns, xj, **kw,
                                      **(jax_kw or {}))
    if kw.get("method", "multistep").startswith("singlestep"):
        ref = run(jnp.asarray(x))      # converts its grid to numpy
    else:
        ref = jax.jit(run)(jnp.asarray(x))
    ref = np.asarray(jax.block_until_ready(ref))
    jax.effects_barrier()
    err = float(np.abs(port.numpy() - ref).max())
    print(f"{kw}: max |port - jax| = {err:.2e} (atol {atol}); "
          f"evaluations {calls}")
    assert port.dtype == torch.float32 and port.shape == SHAPE
    np.testing.assert_allclose(port.numpy(), ref, atol=atol)
    assert calls["port"] == calls["jax"] > 0
    return port, ref, calls


@pytest.mark.parametrize("skip_type", ["time_uniform", "logSNR",
                                       "time_quadratic"])
def test_get_time_steps_match_jax(skip_type):
    ns, jns = _schedules()
    for t_T, t_0, n in ((1.0, 1e-3, 20), (1.0, 1e-3, 3), (0.7, 0.05, 9),
                        (1e-3, 1.0, 6)):
        port = tdpm.get_time_steps(ns, skip_type, t_T, t_0, n)
        ref = np.asarray(jdpm.get_time_steps(jns, skip_type, t_T, t_0, n))
        assert port.dtype == torch.float32 and port.shape == (n + 1,)
        if skip_type == "logSNR":
            # torch.linspace and jnp.linspace may round the last ulp apart
            np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(port.numpy(), ref)


def test_inverse_lambda_matches_jax_over_a_sweep():
    ns, jns = _schedules()
    # beyond both ends of the schedule's half-logSNR range (extrapolated)
    lam = np.linspace(-8.0, 8.0, 401, dtype=np.float32)
    port = ns.inverse_lambda(torch.from_numpy(lam)).numpy()
    np.testing.assert_allclose(port, np.asarray(jns.inverse_lambda(
        jnp.asarray(lam))), rtol=1e-6, atol=1e-7)
    # a 0-d input, and the inverse of marginal_lambda inside the table
    assert ns.inverse_lambda(torch.tensor(0.5)).shape == ()
    t = torch.linspace(2e-3, 0.999, 97)
    np.testing.assert_allclose(
        ns.inverse_lambda(ns.marginal_lambda(t)).numpy(), t.numpy(),
        atol=1e-5)


@pytest.mark.parametrize("lower_order_final", [True, False])
@pytest.mark.parametrize("steps", [3, 5, 6, 10, 12])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_multistep_matches_jax(order, steps, lower_order_final):
    _, _, calls = _compare(dict(order=order, steps=steps,
                                lower_order_final=lower_order_final),
                           seed=10 * order + steps)
    assert calls["port"] == steps


@pytest.mark.parametrize("lower_order_final", [True, False])
@pytest.mark.parametrize("steps", [4, 9])
def test_multistep_order3_tail_matches_jax(steps, lower_order_final):
    """The two grids of the order-3 tail that the sweep above skips: the
    tail's arrivals at orders 2 and 1 after no and after five order-3
    steps."""
    _, _, calls = _compare(dict(order=3, steps=steps,
                                lower_order_final=lower_order_final),
                           seed=steps)
    assert calls["port"] == steps


@pytest.mark.parametrize("method,order,skip_type,steps", [
    ("singlestep", 1, "time_uniform", 6),
    ("singlestep", 2, "time_uniform", 7),
    ("singlestep", 3, "logSNR", 20),
    ("singlestep", 3, "time_quadratic", 10),
    ("singlestep", 3, "time_uniform", 12),
    ("singlestep_fixed", 1, "logSNR", 5),
    ("singlestep_fixed", 2, "time_quadratic", 20),
    ("singlestep_fixed", 3, "time_uniform", 10),
])
def test_singlestep_matches_jax(method, order, skip_type, steps):
    _, _, calls = _compare(dict(method=method, order=order, steps=steps,
                                skip_type=skip_type), seed=order + steps)
    want = (steps if method == "singlestep"
            else order * (steps // order))
    assert calls["port"] == want


@pytest.mark.parametrize("kw", [
    dict(solver_type="taylor", order=2, steps=10),
    dict(solver_type="taylor", order=3, steps=8),
    dict(solver_type="taylor", method="singlestep", order=2, steps=8),
    dict(solver_type="taylor", method="singlestep", order=3, steps=9,
         skip_type="logSNR"),
    dict(algorithm_type="dpmsolver", order=1, steps=6),
    dict(algorithm_type="dpmsolver", order=2, steps=12),
    dict(algorithm_type="dpmsolver", order=3, steps=6),
    dict(algorithm_type="dpmsolver", order=2, steps=20, solver_type="taylor"),
    dict(algorithm_type="dpmsolver", method="singlestep", order=3, steps=10),
    dict(algorithm_type="dpmsolver", method="singlestep", order=2, steps=6,
         solver_type="taylor", skip_type="logSNR"),
    dict(order=2, steps=10, skip_type="logSNR"),
    dict(order=3, steps=12, skip_type="time_quadratic"),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_updates_and_algorithms_match_jax(kw):
    _compare(kw, seed=len(kw))


@pytest.mark.parametrize("kw", [
    dict(correcting_x0_fn="dynamic_thresholding", order=2, steps=10),
    dict(correcting_x0_fn="dynamic_thresholding", order=3, steps=6,
         thresholding_ratio=0.9, thresholding_max_val=1.2),
    dict(correcting_x0_fn="dynamic_thresholding", method="singlestep",
         order=3, steps=9),
    dict(denoise_to_zero=True, order=2, steps=10),
    dict(denoise_to_zero=True, method="singlestep", order=2, steps=6,
         correcting_x0_fn="dynamic_thresholding"),
    # the noise prediction route ignores the x0 correction
    dict(algorithm_type="dpmsolver", correcting_x0_fn="dynamic_thresholding",
         order=2, steps=6),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_corrections_and_denoise_to_zero_match_jax(kw):
    # x0 predictions up to 2.5, so the thresholding clamps
    _, _, calls = _compare(kw, scale=2.5, seed=3)
    assert calls["port"] == kw["steps"] + int(kw.get("denoise_to_zero",
                                                     False))


def test_callable_correction_matches_jax():
    port, _, _ = _compare(
        dict(order=2, steps=8), scale=2.5,
        port_kw=dict(correcting_x0_fn=lambda x0: torch.clamp(x0, -1, 1)),
        jax_kw=dict(correcting_x0_fn=lambda x0: jnp.clip(x0, -1, 1)))
    plain, _, _ = _compare(dict(order=2, steps=8), scale=2.5)
    assert not torch.allclose(port, plain)


def test_dynamic_thresholding_matches_jax():
    x0 = np.random.default_rng(4).normal(scale=2.0, size=(4, 33, 7)).astype(
        np.float32)
    for ratio, max_val in ((0.995, 1.0), (0.5, 0.2), (0.9, 3.0)):
        port = tdpm.dynamic_thresholding(torch.from_numpy(x0), ratio,
                                         max_val)
        ref = jdpm.dynamic_thresholding(jnp.asarray(x0), ratio, max_val)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)
    half = tdpm.dynamic_thresholding(torch.from_numpy(x0).bfloat16())
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [
    dict(t_start=0.8, t_end=0.01, order=2, steps=10),
    dict(t_start=0.6, t_end=0.002, method="singlestep", order=3, steps=9,
         skip_type="logSNR"),
])
def test_solve_interval_matches_jax(kw):
    _compare(kw, seed=5)


@pytest.mark.parametrize("kw", [
    dict(steps=20),
    dict(steps=10, order=3),
    dict(steps=9, method="singlestep", order=3, skip_type="logSNR"),
    dict(steps=12, t_end=0.5),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_inverse_dpmpp_matches_jax(kw):
    # from data of the Gaussian model, which its inversion keeps O(1)
    x = np.sqrt(S2) * np.random.default_rng(6).normal(size=SHAPE)
    _compare(kw, sampler="inverse_dpmpp", x=x.astype(np.float32),
             gauss=True)


@pytest.mark.parametrize("kw", [
    dict(order=2),
    dict(order=3),
    dict(order=2, algorithm_type="dpmsolver", solver_type="taylor"),
    dict(order=3, rtol=0.02, h_init=0.1),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_adaptive_matches_jax(kw):
    _, _, calls = _compare(dict(method="adaptive", **kw), atol=1e-4,
                           seed=7)
    # every iteration evaluates the model `order` times
    assert calls["port"] % kw["order"] == 0


# -- wrap_model ---------------------------------------------------------------

def _wrapped_pair(kw_port, kw_jax):
    ns, jns = _schedules()
    return (tdpm.wrap_model(noise_schedule=ns, **kw_port),
            jdpm.wrap_model(noise_schedule=jns, **kw_jax))


def _hold_x0(port_fn, jax_fn, atol=1e-4):
    """The wrapped callbacks' x0 at four times, within ``atol``: 1e-4, as
    converting a noise, v or score output to x0 divides float32 rounding
    by alpha, 0.0064 at td = 999."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=SHAPE).astype(np.float32)
    for td in (999.0, 500.0, 12.5, 0.0):
        tds = np.full((SHAPE[0],), td, np.float32)
        p = port_fn(torch.from_numpy(x), torch.from_numpy(tds))
        r = jax_fn(jnp.asarray(x), jnp.asarray(tds))
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=atol,
                                   err_msg=f"td {td}")


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
def test_wrap_model_types_match_jax(model_type):
    ns, jns = _schedules()
    port, ref = _gauss(model_type, ns, torch), _gauss(model_type, jns, jnp)
    pf, jf = _wrapped_pair(dict(model=port, model_type=model_type),
                           dict(model=ref, model_type=model_type))
    _hold_x0(pf, jf)
    # and a whole solve through the wrapped model
    x = np.random.default_rng(9).normal(size=SHAPE).astype(np.float32)
    a = tdpm.sample_dpmpp(pf, ns, torch.from_numpy(x), steps=10)
    b = jax.jit(lambda x: jdpm.sample_dpmpp(jf, jns, x, steps=10))(
        jnp.asarray(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _cond_models():
    """``_gauss``'s noise model at x + cond, in both packages."""
    ns, jns = _schedules()
    port, ref = _gauss("noise", ns, torch), _gauss("noise", jns, jnp)
    return (lambda x, td, cond: port(x + cond, td),
            lambda x, td, cond: ref(x + cond, td))


@pytest.mark.parametrize("scale,with_uncond", [(1.0, True), (3.0, True),
                                               (3.0, False)])
def test_classifier_free_guidance_matches_jax(scale, with_uncond):
    port, ref = _cond_models()
    cond = np.random.default_rng(10).normal(size=(1, 1, 5)).astype(
        np.float32)
    unc = np.zeros_like(cond) if with_uncond else None
    common = dict(model_type="noise", guidance_type="classifier-free",
                  guidance_scale=scale)
    pf, jf = _wrapped_pair(
        dict(model=port, condition=torch.from_numpy(cond),
             unconditional_condition=None if unc is None
             else torch.from_numpy(unc), **common),
        dict(model=ref, condition=jnp.asarray(cond),
             unconditional_condition=None if unc is None
             else jnp.asarray(unc), **common))
    _hold_x0(pf, jf)


def test_classifier_guidance_matches_jax():
    """The gradient comes from autograd outside inference mode, on a
    detached input, even under no_grad."""
    ns, jns = _schedules()
    port, ref = _gauss("noise", ns, torch), _gauss("noise", jns, jnp)
    cond = np.linspace(-1, 1, 5, dtype=np.float32)

    def p_cls(x, td, c):
        return (torch.sin(x) * c).sum(dim=(1, 2)) + 1e-4 * td

    def j_cls(x, td, c):
        return (jnp.sin(x) * c).sum(axis=(1, 2)) + 1e-4 * td
    common = dict(model_type="noise", guidance_type="classifier",
                  guidance_scale=0.05)
    pf, jf = _wrapped_pair(
        dict(model=port, classifier_fn=p_cls,
             condition=torch.from_numpy(cond), **common),
        dict(model=ref, classifier_fn=j_cls, condition=jnp.asarray(cond),
             **common))
    with torch.no_grad():
        _hold_x0(pf, jf)
    x = np.random.default_rng(11).normal(size=SHAPE).astype(np.float32)
    a = tdpm.sample_dpmpp(pf, ns, torch.from_numpy(x), steps=6)
    b = jax.jit(lambda x: jdpm.sample_dpmpp(jf, jns, x, steps=6))(
        jnp.asarray(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# -- errors -------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(solver_type="euler"), "solver_type must be"),
    (dict(algorithm_type="ddim"), "algorithm_type must be"),
    (dict(method="heun"), "unsupported method"),
    (dict(skip_type="karras"), "unsupported skip_type"),
    (dict(order=4, steps=6), "order must be 1, 2 or 3"),
    (dict(order=3, steps=2), "3 steps"),
    (dict(method="singlestep", order=4), "order must be 1, 2 or 3"),
    (dict(method="adaptive", order=1), "adaptive solver supports order"),
])
def test_sample_dpmpp_refuses_what_jax_refuses(kw, match):
    ns, _ = _schedules()
    port, _ = _toy(0.8, {"port": 0, "jax": 0})
    with pytest.raises(ValueError, match=match):
        tdpm.sample_dpmpp(port, ns, torch.zeros(1, 2, 3), **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(model_type="eps"), "unsupported model_type"),
    (dict(guidance_type="cfg"), "unsupported guidance_type"),
    (dict(guidance_type="classifier"), "requires classifier_fn"),
])
def test_wrap_model_refuses_what_jax_refuses(kw, match):
    ns, _ = _schedules()
    port = _gauss("noise", ns, torch)
    kw = {"model_type": "noise", **kw}
    fn = tdpm.wrap_model(port, ns, **kw)
    with pytest.raises(ValueError, match=match):
        fn(torch.zeros(1, 2, 3), torch.zeros(1))
