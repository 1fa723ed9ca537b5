"""GPipe over a ``stage`` axis (``parallel.pipeline``) on four gloo ranks
on the CPU (``parallel.launch.pipeline``), against the JAX package's
``make_pipeline`` on four virtual devices and the sequential stack, with
``tests/test_pipeline.py``'s case (8 layers of tanh(x @ w + b), d=16,
batch 8): 4 and 8 micro-batches, rtol 1e-5 / atol 1e-6; the gradients of
sum(out^2) for the stacked w, b and x against ``jax.grad`` of JAX's
pipeline (which equal the sequential stack's), rtol 1e-4 / atol 1e-5 as
the ring's (the micro-batches' parts are summed in another order); the
two shapes JAX refuses
(layers not divisible by the stages, batch not divisible by the
micro-batches) raise ValueError. ``make_mesh`` takes the ``stage`` axis,
and the ``Trainer`` refuses it, as JAX's does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from diff_vits_tpu.parallel.pipeline import make_pipeline
from diff_vits_tpu_torch.parallel import launch, mesh
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_remat import tiny

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(jax.device_count() < 4,
                                reason="needs 4 virtual devices")


def layer_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def case():
    rng = np.random.default_rng(0)
    n_layers, d, b = 8, 16, 8
    params = {"w": (rng.normal(size=(n_layers, d, d)) * 0.3).astype(
                  np.float32),
              "b": (rng.normal(size=(n_layers, d)) * 0.1).astype(np.float32)}
    return params, rng.normal(size=(b, d)).astype(np.float32)


BAD = [({"w": np.zeros((6, 4, 4), np.float32),
         "b": np.zeros((6, 4), np.float32)}, np.zeros((8, 4), np.float32)),
       ({"w": np.zeros((8, 4, 4), np.float32),
         "b": np.zeros((8, 4), np.float32)}, np.zeros((6, 4), np.float32))]


@pytest.fixture(scope="module")
def numbers():
    params, x = case()
    got = launch.run_ranks(launch.calls, 4, [
        (launch.pipeline, (params, x, 4)), (launch.pipeline, (params, x, 8)),
        (launch.pipeline, BAD[0] + (4,)), (launch.pipeline, BAD[1] + (4,))],
        timeout=120)
    return [[r[i] for r in got] for i in range(4)]


def _jax(n_micro):
    params, x = case()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    fn = make_pipeline(layer_fn, Mesh(np.array(jax.devices()[:4]),
                                      ("stage",)), n_microbatches=n_micro)
    out = jax.jit(fn)(params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    seq = jax.lax.scan(lambda h, p: (layer_fn(p, h), None),
                       jnp.asarray(x), params)[0]
    return (np.asarray(out), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx), np.asarray(seq))


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_jax_and_the_sequential_stack(numbers, n_micro):
    out, _, _, seq = _jax(n_micro)
    for r in numbers[0 if n_micro == 4 else 1]:
        np.testing.assert_allclose(r["out"], out, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"], seq, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_gradients_match_jax_grad(numbers, n_micro):
    _, gp, gx, _ = _jax(n_micro)
    for r in numbers[0 if n_micro == 4 else 1]:
        np.testing.assert_allclose(r["dx"], gx, rtol=1e-4, atol=1e-5)
        for k, g in gp.items():
            np.testing.assert_allclose(r["grads"][k], g, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_pipeline_rejects_bad_shapes(numbers):
    for r in numbers[2]:
        assert r["error"] == "6 layers not divisible by 4 stages"
    for r in numbers[3]:
        assert r["error"] == "batch 6 not divisible by 4 microbatches"


def test_stage_axis_is_a_mesh_axis_the_trainer_refuses():
    assert mesh.make_mesh((2, 2), ("data", "stage"), world=4) == {
        "data": 2, "stage": 2}
    _, pcfg = tiny("none")
    cfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, mesh_axes=("stage",)))
    with pytest.raises(ValueError, match="stage"):
        Trainer(cfg, [], device="cpu")
