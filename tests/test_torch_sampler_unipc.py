"""The port's UniPC against the JAX package's, with the same analytic x0
model in both: every variant (bh1, bh2, vary_coeff) at orders 1-3 on the
three grids, with and without the lower-order tail, the order-3 tails at
3-12 steps, noise prediction, and the x0 corrections. Gate: atol 1e-5 and
the same number of model evaluations (one a step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.diffusion import uni_pc as juni
from diff_vits_tpu_torch.diffusion import uni_pc as tuni
from test_torch_sampler import _schedules
from test_torch_sampler_dpm import SHAPE, _toy

torch.set_num_threads(2)


def _compare(kw, *, scale=0.8, seed=0, port_kw=None, jax_kw=None,
             gauss=False):
    """One ``sample_unipc`` of each package on the same seeded x (the toy
    models of ``test_torch_sampler_dpm._toy``), held within atol 1e-5
    with one evaluation a step in both; returns the port's."""
    ns, jns = _schedules()
    x = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    calls = {"port": 0, "jax": 0}
    port_fn, jax_fn = _toy(scale, calls, gauss)
    port = tuni.sample_unipc(port_fn, ns, torch.from_numpy(x), **kw,
                             **(port_kw or {}))
    ref = jax.jit(lambda x: juni.sample_unipc(
        jax_fn, jns, x, **kw, **(jax_kw or {})))(jnp.asarray(x))
    ref = np.asarray(jax.block_until_ready(ref))
    jax.effects_barrier()
    err = float(np.abs(port.numpy() - ref).max())
    print(f"{kw}: max |port - jax| = {err:.2e} (atol 1e-5); evaluations "
          f"{calls}")
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-5)
    assert calls["port"] == calls["jax"] == kw["steps"]
    return port


@pytest.mark.parametrize("lower_order_final", [True, False])
@pytest.mark.parametrize("skip_type", ["time_uniform", "logSNR",
                                       "time_quadratic"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("variant", ["bh1", "bh2", "vary_coeff"])
def test_unipc_variants_match_jax(variant, order, skip_type,
                                  lower_order_final):
    _compare(dict(steps=7, order=order, variant=variant,
                  skip_type=skip_type, lower_order_final=lower_order_final),
             seed=order)


@pytest.mark.parametrize("steps", [3, 4, 5, 6, 9, 10, 12])
@pytest.mark.parametrize("variant", ["bh1", "vary_coeff"])
def test_unipc_order3_tail_matches_jax(variant, steps):
    _compare(dict(steps=steps, order=3, variant=variant), seed=steps)


@pytest.mark.parametrize("kw", [
    dict(variant="bh2", order=2),
    dict(variant="bh1", order=3),
    dict(variant="vary_coeff", order=3, skip_type="logSNR"),
    dict(variant="vary_coeff", order=1, lower_order_final=False),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_unipc_noise_prediction_matches_jax(kw):
    # the Gaussian model: the tanh one's noise (x - alpha x0) / sigma grows
    # to O(100) near t = 0, where float32 rounding alone exceeds 1e-5
    _compare(dict(steps=10, algorithm_type="noise_prediction", **kw),
             seed=5, gauss=True)


@pytest.mark.parametrize("kw", [
    dict(correcting_x0_fn="dynamic_thresholding", variant="bh2", order=2),
    dict(correcting_x0_fn="dynamic_thresholding", variant="bh1", order=3,
         thresholding_ratio=0.9, thresholding_max_val=1.3),
    # the noise prediction route ignores the x0 correction
    dict(correcting_x0_fn="dynamic_thresholding", variant="bh2", order=2,
         algorithm_type="noise_prediction"),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_unipc_thresholding_matches_jax(kw):
    # x0 predictions up to 2.5, so the thresholding clamps
    _compare(dict(steps=10, **kw), scale=2.5, seed=4)


def test_unipc_callable_correction_matches_jax():
    kw = dict(steps=8, variant="bh2")
    port = _compare(
        kw, scale=2.5,
        port_kw=dict(correcting_x0_fn=lambda x0: torch.clamp(x0, -1, 1)),
        jax_kw=dict(correcting_x0_fn=lambda x0: jnp.clip(x0, -1, 1)))
    assert not torch.allclose(port, _compare(kw, scale=2.5))


@pytest.mark.parametrize("kw,match", [
    (dict(order=4, steps=6), "orders 1-3"),
    (dict(order=3, steps=2), "3 steps"),
    (dict(variant="bh3"), "unsupported variant"),
    (dict(algorithm_type="score"), "unsupported algorithm_type"),
    (dict(skip_type="karras"), "unsupported skip_type"),
])
def test_unipc_refuses_what_jax_refuses(kw, match):
    ns, _ = _schedules()
    port, _ = _toy(0.8, {"port": 0, "jax": 0})
    with pytest.raises(ValueError, match=match):
        tuni.sample_unipc(port, ns, torch.zeros(1, 2, 3), **kw)
