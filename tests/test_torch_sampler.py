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
