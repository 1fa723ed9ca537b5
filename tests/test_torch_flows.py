"""The port's flow steps (``nn/flows.py``), flow blocks (``models/flow.py``)
and their building blocks (``DDSConv``, the channel ``LayerNorm``) against
the JAX package, each flow in both directions (forward: y and log|det|;
reverse: y) on a ragged batch, float32, atol 1e-4. ``ConvFlow``'s reverse
is held against the JAX XLA spline and against its Pallas kernel
(interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models import flow as jflow
from diff_vits_tpu.nn import flows as jflows
from diff_vits_tpu.nn import layers as jlayers
from diff_vits_tpu_torch.models import flow as pflow
from diff_vits_tpu_torch.nn import flows as pflows
from diff_vits_tpu_torch.nn import layers as players
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)

B, T, GIN, FC = 2, 13, 8, 16
LENGTHS = np.array([13, 9])

# name: (JAX module, port module, channels, g width (None: no g; a g of
# width FC varies over time, a speaker g of width GIN does not))
STEPS = {
    "affine": (lambda: jflows.ElementwiseAffine(4),
               lambda: pflows.ElementwiseAffine(4), 4, None),
    "residual_mean_only": (
        lambda: jflows.ResidualCouplingLayer(4, FC, 5, 1, 3, gin_channels=GIN,
                                             mean_only=True),
        lambda: pflows.ResidualCouplingLayer(4, FC, 5, 1, 3, gin_channels=GIN,
                                             mean_only=True), 4, GIN),
    "residual_affine": (
        lambda: jflows.ResidualCouplingLayer(6, FC, 3, 2, 2),
        lambda: pflows.ResidualCouplingLayer(6, FC, 3, 2, 2), 6, None),
    "conv_flow": (lambda: jflows.ConvFlow(2, FC, 3, 3),
                  lambda: pflows.ConvFlow(2, FC, 3, 3), 2, FC),
    "conv_flow_pallas": (lambda: jflows.ConvFlow(2, FC, 3, 3, use_fused=True),
                         lambda: pflows.ConvFlow(2, FC, 3, 3), 2, FC),
    "transformer": (
        lambda: jflows.TransformerCouplingLayer(4, FC, 3, 2, 2, 0.0, FC,
                                                mean_only=True,
                                                gin_channels=GIN),
        lambda: pflows.TransformerCouplingLayer(4, FC, 3, 2, 2, 0.0, FC,
                                                mean_only=True,
                                                gin_channels=GIN), 4, GIN),
    "residual_block": (
        lambda: jflow.ResidualCouplingBlock(4, FC, 5, 1, 2, n_flows=2,
                                            gin_channels=GIN),
        lambda: pflow.ResidualCouplingBlock(4, FC, 5, 1, 2, n_flows=2,
                                            gin_channels=GIN, device="cpu"),
        4, GIN),
    "transformer_block": (
        lambda: jflow.TransformerCouplingBlock(4, FC, FC, 2, 2, 3, n_flows=2,
                                               gin_channels=GIN),
        lambda: pflow.TransformerCouplingBlock(4, FC, FC, 2, 2, 3, n_flows=2,
                                               gin_channels=GIN,
                                               device="cpu"), 4, GIN),
}


def _inputs(channels, g_width, seed):
    rng = np.random.default_rng(seed)
    # spread 3 puts some spline inputs outside tail_bound 5 after scaling
    x = (3.0 * rng.normal(size=(B, T, channels))).astype(np.float32)
    mask = (np.arange(T)[None] < LENGTHS[:, None]).astype(
        np.float32)[..., None]
    g = None
    if g_width is not None:
        steps = 1 if g_width == GIN else T
        g = rng.normal(size=(B, steps, g_width)).astype(np.float32)
    return x * mask, mask, g


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("name", list(STEPS))
def test_flow_matches_jax(name, reverse):
    jfn, pfn, channels, g_width = STEPS[name]
    x, mask, g = _inputs(channels, g_width, seed=len(name))
    jm = jfn()
    j = dict(g=None if g is None else jnp.asarray(g))
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(mask), **j),
                seed=len(name) + 1)
    ref = jm.apply(to_jax(tree), jnp.asarray(x), jnp.asarray(mask),
                   reverse=reverse, **j)
    pm = load(pfn(), tree)
    t = dict(g=None if g is None else torch.from_numpy(g))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(mask),
                 reverse=reverse, **t)
    if reverse or name.endswith("_block"):
        assert_close(out, ref, 1e-4)
    else:
        assert_close(out[0], ref[0], 1e-4)
        assert_close(out[1], ref[1], 1e-4, rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_log_and_flip_match_jax(reverse):
    x, mask, _ = _inputs(2, None, seed=3)
    x = np.abs(x) + 0.1 if not reverse else x
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    for jm, pm in ((jflows.Log(), pflows.Log()), (jflows.Flip(),
                                                  pflows.Flip())):
        ref = jm.apply({}, jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
        out = pm(tx, tm, reverse=reverse)
        if reverse:
            assert_close(out, ref, 1e-5)
        else:
            assert_close(out[0], ref[0], 1e-5)
            assert_close(out[1], ref[1], 1e-4)


def test_dds_conv_and_layer_norm_match_jax():
    x, mask, g = _inputs(FC, FC, seed=5)
    jm = jlayers.DDSConv(FC, 3, 3)
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(mask),
                            g=jnp.asarray(g)), seed=6)
    ref = jm.apply(to_jax(tree), jnp.asarray(x), jnp.asarray(mask),
                   g=jnp.asarray(g))
    pm = load(players.DDSConv(FC, 3, 3), tree)
    assert pm.conv_sep_1.weight.shape == (FC, 1, 3)    # depthwise [C, 1, k]
    with torch.no_grad():
        assert_close(pm(torch.from_numpy(x), torch.from_numpy(mask),
                        g=torch.from_numpy(g)), ref, 1e-4)
    jln = jlayers.LayerNorm(FC)
    tree = fill(flax_shapes(jln, jnp.asarray(x)), seed=7)
    pln = load(players.LayerNorm(FC), tree)
    with torch.no_grad():
        assert_close(pln(torch.from_numpy(x)),
                     jln.apply(to_jax(tree), jnp.asarray(x)), 1e-5)
