"""The port's plain RQ spline (``ops/spline.py``, K7's plain version and the
CPU route of its wrapper ``unconstrained_rqs``) against the JAX package:
the XLA formulation ``unconstrained_rational_quadratic_spline`` and the
Pallas kernel ``unconstrained_rqs_pallas`` in interpret mode. Tolerances
as in tests/test_spline_pallas.py: outputs atol/rtol 1e-5, log|det|
1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.ops.spline import (
    unconstrained_rational_quadratic_spline as jax_spline)
from diff_vits_tpu.ops.spline_pallas import unconstrained_rqs_pallas
from diff_vits_tpu_torch import ops
from diff_vits_tpu_torch.ops import spline

torch.set_num_threads(2)


def _params(shape=(4, 96), num_bins=10, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * spread).astype(np.float32)
    uw = rng.normal(size=shape + (num_bins,)).astype(np.float32)
    uh = rng.normal(size=shape + (num_bins,)).astype(np.float32)
    ud = rng.normal(size=shape + (num_bins - 1,)).astype(np.float32)
    return x, uw, uh, ud


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tail_bound", [1.0, 5.0])
def test_plain_spline_matches_jax_xla_and_pallas(inverse, tail_bound):
    arrays = _params()
    kw = dict(inverse=inverse, tail_bound=tail_bound)
    j = [jnp.asarray(a) for a in arrays]
    ref_out, ref_ld = jax_spline(*j, **kw)
    pal_out, pal_ld = unconstrained_rqs_pallas(*j, interpret=True, **kw)
    t = [torch.from_numpy(a) for a in arrays]
    plain = spline.unconstrained_rational_quadratic_spline(*t, **kw)
    before = ops.launch_counts()
    routed = spline.unconstrained_rqs(*t, **kw)       # CPU: the plain route
    assert ops.launch_counts() == before
    assert routed[0].dtype == routed[1].dtype == torch.float32
    for out, ld in (plain, routed):
        for ref_o, ref_l in ((ref_out, ref_ld), (pal_out, pal_ld)):
            _close(out, ref_o, 1e-5)
            _close(ld, ref_l, 1e-4)
    # inputs on both sides of the tails: identity and log|det| 0 outside
    outside = np.abs(arrays[0]) > tail_bound
    assert outside.any() and (~outside).any()
    np.testing.assert_array_equal(routed[0].numpy()[outside],
                                  arrays[0][outside])
    assert not routed[1].numpy()[outside].any()


def test_round_trip():
    x, uw, uh, ud = map(torch.from_numpy, _params(spread=0.8, seed=3))
    y, ld = spline.unconstrained_rqs(x, uw, uh, ud, inverse=False)
    x2, ld_inv = spline.unconstrained_rqs(y, uw, uh, ud, inverse=True)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-4)
    # log|det| cancellation is float32-limited near bin edges
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=1e-3)


def test_1d_input():
    arrays = _params(shape=(64,), seed=5)
    ref_out, ref_ld = jax_spline(*[jnp.asarray(a) for a in arrays])
    out, ld = spline.unconstrained_rqs(*map(torch.from_numpy, arrays))
    assert out.shape == (64,)
    _close(out, ref_out, 1e-5)
    _close(ld, ref_ld, 1e-4)


def test_bfloat16_inputs_compute_in_float32():
    """As the Pallas kernel: float32 inside, outputs in the input dtype,
    log|det| float32."""
    arrays = _params(seed=7)
    t16 = [torch.from_numpy(a).bfloat16() for a in arrays]
    out, ld = spline.unconstrained_rqs(*t16, inverse=True, tail_bound=5.0)
    assert out.dtype == torch.bfloat16 and ld.dtype == torch.float32
    ref_out, ref_ld = spline.unconstrained_rqs(
        *[t.float() for t in t16], inverse=True, tail_bound=5.0)
    assert torch.equal(out, ref_out.bfloat16())
    assert torch.equal(ld, ref_ld)
