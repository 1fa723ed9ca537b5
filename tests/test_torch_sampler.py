"""Port's noise schedule and UniPC sampler against the JAX package, with
the same analytic x0 model in both (float32, atol 1e-5), and the same
number of model evaluations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.diffusion import dpm_solver as jdpm
from diff_vits_tpu.diffusion import uni_pc as juni
from diff_vits_tpu.diffusion.noise_schedule import NoiseScheduleVP as JNS
from diff_vits_tpu.diffusion.schedule import linear_beta_schedule as jbetas
from diff_vits_tpu_torch.diffusion import dpm_solver as tdpm
from diff_vits_tpu_torch.diffusion import uni_pc as tuni
from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP
from diff_vits_tpu_torch.diffusion.schedule import linear_beta_schedule

torch.set_num_threads(2)


def _schedules(n=1000):
    np.testing.assert_array_equal(linear_beta_schedule(n), jbetas(n))
    return NoiseScheduleVP(linear_beta_schedule(n)), JNS(jbetas(n))


def test_noise_schedule_tables_and_grid_match_jax():
    ns, jns = _schedules()
    np.testing.assert_array_equal(ns.t_array.numpy(), np.asarray(jns.t_array))
    np.testing.assert_array_equal(ns.log_alpha_array.numpy(),
                                  np.asarray(jns.log_alpha_array))
    for steps in (30, 7):
        np.testing.assert_array_equal(
            tdpm.time_steps_uniform(ns, steps).numpy(),
            np.asarray(jdpm.time_steps_uniform(jns, steps)))
    t = np.array([1e-3, 0.0015, 0.25, 0.5004, 0.999, 1.0], np.float32)
    for name in ("marginal_log_mean_coeff", "marginal_alpha",
                 "marginal_std", "marginal_lambda"):
        np.testing.assert_allclose(
            getattr(ns, name)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(jns, name)(jnp.asarray(t))),
            rtol=1e-6, atol=1e-6, err_msg=name)


def _x0_torch(x, td, i):
    return 0.8 * torch.tanh(x) + 1e-4 * td[:, None, None] + 0.01 * i


def _x0_jax(x, td, i):
    return 0.8 * jnp.tanh(x) + 1e-4 * td[:, None, None] + 0.01 * i


@pytest.mark.parametrize("steps", [
    30,     # the serving default
    10,
    2,      # the order-1 warm-up, then the order-1 final step alone
])
def test_unipc_matches_jax(steps):
    ns, jns = _schedules()
    x = np.random.default_rng(steps).normal(size=(3, 17, 5)).astype(
        np.float32)
    calls = {"port": 0, "jax": 0}

    def port_fn(x, td, i):
        calls["port"] += 1
        return _x0_torch(x, td, i)

    def jax_fn(x, td, i):
        jax.debug.callback(lambda: calls.__setitem__("jax",
                                                     calls["jax"] + 1))
        return _x0_jax(x, td, i)

    port = tuni.sample_unipc(port_fn, ns, torch.from_numpy(x), steps=steps)
    ref = juni.sample_unipc(jax_fn, jns, jnp.asarray(x), steps=steps,
                            order=2, variant="bh2")
    ref = np.asarray(jax.block_until_ready(ref))
    jax.effects_barrier()
    print(f"max |port - jax| = {np.abs(port.numpy() - ref).max():.2e} "
          "(atol 1e-5)")
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    assert calls["port"] == calls["jax"] == steps


def test_unipc_two_argument_model_gets_no_step_index():
    ns, _ = _schedules()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 6, 3)).astype(np.float32))
    two = tuni.sample_unipc(lambda x, td: _x0_torch(x, td, 0), ns, x,
                            steps=6)
    three = tuni.sample_unipc(lambda x, td, i: _x0_torch(x, td, 0), ns, x,
                              steps=6)
    torch.testing.assert_close(two, three, atol=0, rtol=0)


@pytest.mark.parametrize("steps", [
    30,     # the serving default: order 2 to the end
    10,     # the shortest grid whose last step keeps order 2
    2,      # the order-1 warm-up, then the lower-order final step alone
])
def test_dpmpp_matches_jax(steps):
    ns, jns = _schedules()
    x = np.random.default_rng(50 + steps).normal(size=(3, 17, 5)).astype(
        np.float32)
    calls = {"port": 0, "jax": 0}

    def port_fn(x, td, i):
        calls["port"] += 1
        return _x0_torch(x, td, i)

    def jax_fn(x, td, i):
        jax.debug.callback(lambda: calls.__setitem__("jax",
                                                     calls["jax"] + 1))
        return _x0_jax(x, td, i)

    port = tdpm.sample_dpmpp(port_fn, ns, torch.from_numpy(x), steps=steps)
    ref = jdpm.sample_dpmpp(jax_fn, jns, jnp.asarray(x), steps=steps,
                            order=2)
    ref = np.asarray(jax.block_until_ready(ref))
    jax.effects_barrier()
    print(f"max |port - jax| = {np.abs(port.numpy() - ref).max():.2e} "
          "(atol 1e-5)")
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    assert calls["port"] == calls["jax"] == steps


def test_dpmpp_refuses_one_step():
    ns, _ = _schedules()
    with pytest.raises(ValueError, match="2 steps"):
        tdpm.sample_dpmpp(_x0_torch, ns, torch.zeros(1, 2, 3), steps=1)


# the integer-step samplers (DDIM, DDPM) call the model on t [B] steps
def _x0_steps_torch(x, t):
    return 0.8 * torch.tanh(x) + 1e-4 * t[:, None, None].float()


def _x0_steps_jax(x, t):
    return 0.8 * jnp.tanh(x) + 1e-4 * t[:, None, None].astype(jnp.float32)


def _jax_draws(key, n, shape):
    """The normal draws JAX's ddim_sample / p_sample_loop make, in order:
    one split for x_T, then one split a step."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _diffusions(n):
    from diff_vits_tpu.diffusion.schedule import GaussianDiffusion as JGD
    from diff_vits_tpu_torch.diffusion.schedule import GaussianDiffusion
    port, ref = GaussianDiffusion.create(n), JGD.create(n)
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "loss_weight"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    return port, ref


@pytest.mark.parametrize("steps,eta", [
    (30, 0.0),  # what synthesize runs
    (10, 0.0),
    (10, 0.5),  # stochastic: JAX's draws fed in
])
def test_ddim_matches_jax(steps, eta):
    port_gd, jax_gd = _diffusions(1000)
    shape = (3, 17, 5)
    x = np.random.default_rng(70 + steps).normal(size=shape).astype(
        np.float32)
    key = jax.random.PRNGKey(steps)
    calls = []

    def port_fn(x, t):
        calls.append(int(t[0]))
        return _x0_steps_torch(x, t)

    port = port_gd.ddim_sample(
        port_fn, torch.from_numpy(x), steps, eta=eta,
        noise=[torch.from_numpy(d) for d in _jax_draws(key, steps, shape)])
    ref = np.asarray(jax.jit(
        lambda x: jax_gd.ddim_sample(_x0_steps_jax, shape, key, steps=steps,
                                     eta=eta, init_noise=x))(jnp.asarray(x)))
    print(f"max |port - jax| = {np.abs(port.numpy() - ref).max():.2e} "
          "(atol 1e-5)")
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    times = np.linspace(-1, 999, steps + 1).astype(int)[::-1]
    assert calls == times[:-1].tolist()


def test_p_sample_loop_matches_jax_with_its_draws():
    n = 100
    port_gd, jax_gd = _diffusions(n)
    shape = (2, 9, 5)
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    calls = []

    def port_fn(x, t):
        calls.append(int(t[0]))
        return _x0_steps_torch(x, t)

    port = port_gd.p_sample_loop(
        port_fn, torch.from_numpy(x),
        noise=[torch.from_numpy(d) for d in _jax_draws(key, n, shape)])
    ref = np.asarray(jax.jit(
        lambda x: jax_gd.p_sample_loop(_x0_steps_jax, shape, key,
                                       init_noise=x))(jnp.asarray(x)))
    print(f"max |port - jax| = {np.abs(port.numpy() - ref).max():.2e} "
          "(atol 1e-5)")
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    assert calls == list(range(n - 1, -1, -1))


def test_p_sample_loop_draws_from_the_generator():
    port_gd, _ = _diffusions(20)
    x = torch.zeros(2, 3, 4)
    a = port_gd.p_sample_loop(_x0_steps_torch, x,
                              generator=torch.Generator().manual_seed(1))
    b = port_gd.p_sample_loop(_x0_steps_torch, x,
                              generator=torch.Generator().manual_seed(1))
    c = port_gd.p_sample_loop(_x0_steps_torch, x,
                              generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
