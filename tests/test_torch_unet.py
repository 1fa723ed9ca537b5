"""Port's UNet1DConditionModel (tiny) against the JAX package's XLA path.

Same flax parameter tree (filled from a numpy seed) and the same numpy
inputs in both; float32; atol 1e-4. T = 37 exercises the upsample size
forcing on odd lengths (37 -> 19 -> 10 -> 5 and back). The JAX side runs
jitted: one compile per input shape costs less than eager dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn.unet1d import UNet1DConditionModel as JUNet
from diff_vits_tpu_torch.nn.unet1d import (
    UNet1DConditionModel, set_use_fused)
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)

KW = dict(in_channels=8, out_channels=4, block_out_channels=(16, 16, 32, 32),
          cross_attention_dim=16, attention_head_dim=4)
ATOL = 1e-4


def _inputs(b, t, s, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 8)).astype(np.float32)
    ts = rng.uniform(0, 999, size=(b,)).astype(np.float32)
    ctx = rng.normal(size=(b, s, 16)).astype(np.float32)
    lengths = np.array([s, s - 4, 1][:b])
    keep = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    return x, ts, ctx, keep


@pytest.fixture(scope="module")
def models():
    jm = JUNet(**KW)
    x, ts, ctx, keep = _inputs(2, 16, 9)
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(ts),
                            jnp.asarray(ctx), jnp.asarray(keep)), seed=7)
    pm = load(UNet1DConditionModel(**KW, device="cpu"), tree)
    return (jax.jit(jm.apply, static_argnames=("embedding_request",)),
            to_jax(tree), pm)


def _both(models, *arrays, emb=None, **kw):
    japply, params, pm = models
    with torch.no_grad():
        port = pm(*[None if a is None else torch.from_numpy(a)
                    for a in arrays], **kw,
                  emb=None if emb is None else torch.from_numpy(emb))
    ref = japply(params, *[None if a is None else jnp.asarray(a)
                             for a in arrays], **kw,
                   emb=None if emb is None else jnp.asarray(emb))
    return port, ref


@pytest.mark.parametrize("b,t", [(2, 37), (1, 5)])
def test_unet_matches_jax_xla_path(models, b, t):
    x, ts, ctx, keep = _inputs(b, t, 9, seed=t)
    port, ref = _both(models, x, ts, ctx, keep)
    assert port.shape == (b, t, 4)
    assert_close(port, ref, ATOL)


def test_unet_unfused_formulation_matches_jax(models):
    pm = models[2]
    x, ts, ctx, keep = _inputs(2, 37, 9, seed=1)
    set_use_fused(pm, False)
    try:
        port, ref = _both(models, x, ts, ctx, keep)
    finally:
        set_use_fused(pm, True)
    assert_close(port, ref, ATOL)


def test_unet_scalar_timestep_and_no_mask(models):
    x, _, ctx, _ = _inputs(2, 37, 9, seed=2)
    japply, params, pm = models
    with torch.no_grad():
        port = pm(torch.from_numpy(x), torch.ones((), dtype=torch.int32),
                  torch.from_numpy(ctx))
    ref = japply(params, jnp.asarray(x), jnp.ones((), jnp.int32),
                 jnp.asarray(ctx))
    assert_close(port, ref, ATOL)


def test_unet_embedding_requests_and_emb_path(models):
    x, ts, ctx, keep = _inputs(2, 37, 9, seed=3)
    grid = np.array([999.0, 500.0, 0.0], np.float32)
    port_t, ref_t = _both(models, None, grid, None,
                          embedding_request="time")
    assert_close(port_t, ref_t, ATOL)
    port_a, ref_a = _both(models, None, None, ctx, embedding_request="text")
    assert_close(port_a, ref_a, ATOL)
    # the hoisted sampler path: emb = time(t_i) + text(prompt), injected
    emb = (np.asarray(ref_t)[1][None] + np.asarray(ref_a)).astype(np.float32)
    port, ref = _both(models, x, ts, ctx, keep, emb=emb)
    assert_close(port, ref, ATOL)
    full_port, _ = _both(models, x, np.full((2,), 500.0, np.float32), ctx,
                         keep)
    assert_close(port, np.asarray(full_port), ATOL)
