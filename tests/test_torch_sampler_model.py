"""The sampler library over the tiny DiffVits, the port against the JAX
package: the same weights (carried by from_flax_params), each package's
own content (VITS prior, zero prior noise) and prompt keys, then JAX's
samplers over ``denoise_cached`` without the hoisted embeddings and the
port's over ``DiffusionEncoder.denoise``, both with a 2-argument callback,
from the same numpy x_T. Settings: DPM-Solver++ singlestep order 3 on the
logSNR grid, multistep order 3, UniPC bh1 order 3, and the adaptive
solver at order 2. Gate: max |mel diff| <= 5e-3 (the gate of
tests/test_e2e_sample_parity.py) and equal denoiser calls.

The adaptive solver runs with atol = rtol = 0.5, a solve of 7 steps. Its
step control makes every trajectory sensitive to rounding: the next step
scales by E^(-1/2) of the error norm E, so a rounding-level difference of
E moves the next time, and the random UNet's sinusoidal time embedding
turns that into a mel difference. At these controls three iterations
already place the two packages' evaluations up to 4.6e-3 of a discrete
step apart (x_T seed 42); with JAX's default controls (atol 0.0078, rtol
0.05) the trajectories part (156 against 160 evaluations, max |mel diff|
1.04, x_T seed 42). The analytic models of
tests/test_torch_sampler_dpm.py hold the defaults' trajectory within 1e-4
with equal evaluations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.diffusion import dpm_solver as jdpm
from diff_vits_tpu.diffusion import uni_pc as juni
from diff_vits_tpu.diffusion.noise_schedule import NoiseScheduleVP as JNS
from diff_vits_tpu.diffusion.schedule import linear_beta_schedule as jbetas
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu_torch.diffusion import dpm_solver as tdpm
from diff_vits_tpu_torch.diffusion import uni_pc as tuni
from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP
from diff_vits_tpu_torch.diffusion.schedule import linear_beta_schedule
from test_torch_synthesize import GATE, ORDER, make_batch, tiny_models

torch.set_num_threads(2)

B, MAX_LEN = 2, 40


@pytest.fixture(scope="module")
def denoisers():
    """(port callback, JAX callback, x_T, calls): each package's denoiser
    over its own content and prompt keys for one ragged batch of 2."""
    jm, params, pm = tiny_models(seed=5)
    data = make_batch(B, 8, 11, seed=40)
    jargs = [jnp.asarray(data[k]) for k in ORDER]
    targs = [torch.from_numpy(data[k]) for k in ORDER]
    content_j, len_j = jax.jit(lambda p, *a: jm.apply(
        p, *a, noise_key=jax.random.PRNGKey(0), noise_scale=0.0,
        max_len=MAX_LEN, method=JDiffVits.vits_infer))(params, *jargs)
    ph_j, pk_j = jax.jit(lambda p, *a: jm.apply(
        p, *a, method=JDiffVits.encode_prompt))(params, jargs[2], jargs[3])
    dm = pm.diff_model
    with torch.inference_mode():
        content, lengths = pm.vits.infer(*targs, noise_scale=0.0,
                                         max_len=MAX_LEN)
        ph, pk = dm.encode_prompt(targs[2], targs[3])
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(len_j))
    np.testing.assert_allclose(content.numpy(), np.asarray(content_j),
                               atol=1e-4)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), atol=1e-4)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(pk_j))
    calls = {"port": 0, "jax": 0}

    def port_fn(x, td):
        calls["port"] += 1
        with torch.inference_mode():
            return dm.denoise(x, td, content, ph, pk)

    denoise = jax.jit(lambda x, td: jm.apply(
        params, x, td, content_j, ph_j, pk_j,
        method=JDiffVits.denoise_cached))

    def jax_fn(x, td):
        jax.debug.callback(lambda: calls.__setitem__("jax",
                                                     calls["jax"] + 1))
        return denoise(x, td)

    x_t = np.random.default_rng(44).normal(size=(B, MAX_LEN, 100)).astype(
        np.float32)
    return port_fn, jax_fn, x_t, calls


def _ns():
    return (NoiseScheduleVP(linear_beta_schedule(1000)),
            JNS(jbetas(1000)))


@pytest.mark.parametrize("sampler,kw,evals", [
    ("dpm", dict(method="singlestep", order=3, skip_type="logSNR",
                 steps=12), 12),
    ("dpm", dict(order=3, steps=10), 10),
    ("unipc", dict(variant="bh1", order=3, steps=10), 10),
    ("dpm", dict(method="adaptive", order=2, atol=0.5, rtol=0.5), 14),
], ids=["singlestep3-logSNR", "multistep3", "unipc-bh1-3", "adaptive2"])
def test_sampler_over_the_denoiser_matches_jax(denoisers, sampler, kw,
                                               evals):
    port_fn, jax_fn, x_t, calls = denoisers
    calls.update(port=0, jax=0)
    ns, jns = _ns()
    port_sample = tdpm.sample_dpmpp if sampler == "dpm" else \
        tuni.sample_unipc
    jax_sample = jdpm.sample_dpmpp if sampler == "dpm" else \
        juni.sample_unipc
    mel = port_sample(port_fn, ns, torch.from_numpy(x_t), **kw)
    ref = np.asarray(jax.block_until_ready(
        jax_sample(jax_fn, jns, jnp.asarray(x_t), **kw)))
    jax.effects_barrier()
    assert mel.shape == (B, MAX_LEN, 100) and mel.dtype == torch.float32
    err = float(np.abs(mel.numpy() - ref).max())
    print(f"{sampler} {kw}: max |mel diff| = {err:.2e} (gate {GATE}); "
          f"denoiser calls {calls}")
    assert err <= GATE, err
    assert calls["port"] == calls["jax"] > 0
    if evals is not None:
        assert calls["port"] == evals
