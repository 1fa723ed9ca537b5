"""Ring attention of the port (``parallel.ring_attention``) on 2 and 4
gloo ranks on the CPU (``parallel.launch.ring``), against the JAX
package's ``make_ring_attention`` on as many virtual devices, with the
cases of ``tests/test_ring_attention.py``: ragged keep masks (b=2, h=4,
T=64, d=16; item 0 keeps 50 keys, item 1 keeps 37) and no mask (b=1,
h=2, T=40, d=8), atol 1e-5; and the gradients of sum(out^2) for q, k and
v (each block's through the ring's backward) against ``jax.grad`` of
JAX's ring and of full attention, rtol 1e-4 / atol 1e-5, on the ragged
case and on ``test_ring_attention.py:123``'s (b=1, h=2, T=32, d=8). An
item that keeps no key at all gets 0, as JAX's ring gives it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from diff_vits_tpu.ops.attention import scaled_dot_product_attention
from diff_vits_tpu.parallel.ring_attention import make_ring_attention
from diff_vits_tpu_torch.parallel import launch

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 4,
                                reason="needs 4 virtual devices")


def _qkv(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, t, d)).astype(np.float32)
                 for _ in range(3))


def ragged():
    keep = np.ones((2, 64), bool)
    keep[0, 50:] = False
    keep[1, 37:] = False
    return _qkv(0, 2, 4, 64, 16) + (keep,)


def unmasked():
    return _qkv(1, 1, 2, 40, 8) + (np.ones((1, 40), bool),)


def trainable():
    return _qkv(2, 1, 2, 32, 8) + (np.ones((1, 32), bool),)


def empty_item():
    q, k, v, keep = ragged()
    keep = keep.copy()
    keep[1] = False
    return q, k, v, keep


CASES = {"ragged": ragged, "unmasked": unmasked, "trainable": trainable,
         "empty_item": empty_item}


@functools.lru_cache(maxsize=None)
def _jax(n, case):
    q, k, v, keep = map(jnp.asarray, CASES[case]())
    ring = make_ring_attention(Mesh(np.array(jax.devices()[:n]), ("seq",)),
                               "seq")
    out = jax.jit(ring)(q, k, v, keep)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v, keep)
                                                     ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4])
def numbers(request):
    n = request.param
    names = list(CASES)
    got = launch.run_ranks(launch.calls, n, [
        (launch.ring, CASES[c]()) for c in names], timeout=120)
    return n, {c: [r[i] for r in got] for i, c in enumerate(names)}


def test_ring_matches_jax_ring_and_full_attention(numbers):
    n, got = numbers
    q, k, v, keep = map(jnp.asarray, ragged())
    full = np.asarray(scaled_dot_product_attention(
        q, k, v, mask=keep[:, None, None, :]))
    want, _ = _jax(n, "ragged")
    for r in got["ragged"]:
        np.testing.assert_allclose(r["out"], want, atol=1e-5)
        np.testing.assert_allclose(r["out"][:, :, :37], full[:, :, :37],
                                   atol=1e-5)
        np.testing.assert_allclose(r["out"][0, :, :50], full[0, :, :50],
                                   atol=1e-5)


def test_ring_without_a_mask_matches_jax(numbers):
    n, got = numbers
    q, k, v, _ = map(jnp.asarray, unmasked())
    full = np.asarray(scaled_dot_product_attention(q, k, v))
    want, _ = _jax(n, "unmasked")
    for r in got["unmasked"]:
        np.testing.assert_allclose(r["out"], want, atol=1e-5)
        np.testing.assert_allclose(r["out"], full, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "trainable"])
def test_ring_gradients_match_jax_grad(numbers, case):
    n, got = numbers
    _, want = _jax(n, case)
    for r in got[case]:
        for a, b in zip(r["grads"], want):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_ring_gradients_match_full_attention(numbers):
    _, got = numbers
    q, k, v, _ = map(jnp.asarray, trainable())
    want = jax.grad(lambda q, k, v: jnp.sum(
        scaled_dot_product_attention(q, k, v) ** 2), argnums=(0, 1, 2))(
            q, k, v)
    for r in got["trainable"]:
        for a, b in zip(r["grads"], want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


def test_an_item_keeping_no_key_gets_zero(numbers):
    n, got = numbers
    want, grads = _jax(n, "empty_item")
    for r in got["empty_item"]:
        assert np.all(r["out"][1] == 0)
        np.testing.assert_allclose(r["out"], want, atol=1e-5)
        for a, b in zip(r["grads"], grads):
            assert np.all(np.isfinite(a))
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
