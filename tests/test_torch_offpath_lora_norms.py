"""The port's LoRA layers, adaptive norms (AdaLayerNorm, AdaGroupNorm,
SpatialNorm) and DualTransformer1D against the JAX package (CPU, float32,
atol = rtol = 1e-5).

The numpy fill gives LoRA's ``up`` non-zero weights, so the adapter branch
takes part; a fresh port adapter starts at zero, as JAX's does.
DualTransformer1D runs on both of its transformers' routes (the fused ops'
plain versions on the CPU, and the unfused formulation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import lora as JL
from diff_vits_tpu.nn import unet1d as JU
from diff_vits_tpu_torch.nn import lora as PL
from diff_vits_tpu_torch.nn import unet1d as PU
from diff_vits_tpu_torch.utils.convert import to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax
from test_torch_offpath_layers import assert_tree_equal

torch.set_num_threads(2)
TOL = 1e-5


def _x(b=2, t=11, c=12, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, c)).astype(
        np.float32)


def run_both(jm, pm, *arrays, seed=0, fix=None):
    jargs = [jnp.asarray(a) for a in arrays]
    tree = fill(flax_shapes(jm, *jargs), seed=seed)
    if fix is not None:
        fix(tree)
    load(pm, tree)
    with torch.no_grad():
        got = pm(*[torch.from_numpy(np.asarray(a)) for a in arrays])
    assert_close(got, jm.apply(to_jax(tree), *jargs), atol=TOL, rtol=TOL)
    assert_tree_equal(to_flax_params(pm), tree)
    return tree


@pytest.mark.parametrize("rank,alpha,bias", [(0, None, True), (2, None, True),
                                             (4, 2.0, False)])
def test_lora_dense_matches_jax(rank, alpha, bias):
    run_both(JL.LoRACompatibleDense(10, use_bias=bias, rank=rank,
                                    network_alpha=alpha),
             PL.LoRACompatibleDense(12, 10, use_bias=bias, rank=rank,
                                    network_alpha=alpha), _x())


@pytest.mark.parametrize("k,stride,padding", [(1, 1, "SAME"), (3, 1, "SAME"),
                                              (4, 2, "SAME"), (3, 2, "VALID")])
@pytest.mark.parametrize("rank,alpha", [(0, None), (2, 1.0)])
def test_lora_conv_matches_jax(k, stride, padding, rank, alpha):
    run_both(JL.LoRACompatibleConv(10, (k,), (stride,), padding, rank=rank,
                                   network_alpha=alpha),
             PL.LoRACompatibleConv(12, 10, (k,), (stride,), padding,
                                   rank=rank, network_alpha=alpha), _x())


def test_lora_adapters_start_at_the_base_function():
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_x())
    dense = PL.LoRACompatibleDense(12, 10, rank=3, network_alpha=1.0,
                                   generator=g)
    conv = PL.LoRACompatibleConv(12, 10, 3, rank=3, generator=g)
    for m in (dense, conv):
        assert float(m.lora.up.weight.detach().abs().max()) == 0.0
        # down ~ N(0, 1/rank)
        std = float(m.lora.down.weight.detach().std())
        assert 0.15 < std < 0.6
        torch.testing.assert_close(m(x), m.base(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rank"):
        PL.LoRALinearLayer(12, 2, rank=3)
    jax_tree = fill(flax_shapes(JL.LoRALinearLayer(10, 2), jnp.zeros((1,
                                                                       12))))
    pm = load(PL.LoRALinearLayer(12, 10, 2), jax_tree)
    assert_tree_equal(to_flax_params(pm), jax_tree)


@pytest.mark.parametrize("batched", [False, True])
def test_ada_layer_norm_matches_jax(batched):
    x = _x()
    t = np.array([3, 7]) if batched else np.array(5)
    run_both(JU.AdaLayerNorm(12, 10), PU.AdaLayerNorm(12, 10), x, t)


@pytest.mark.parametrize("act", [None, "silu", "swish", "mish", "gelu"])
def test_ada_group_norm_matches_jax(act):
    emb = _x(t=1, c=9, seed=1)[:, 0]
    run_both(JU.AdaGroupNorm(9, 12, 3, act_fn=act, eps=1e-6),
             PU.AdaGroupNorm(9, 12, 3, act_fn=act, eps=1e-6), _x(), emb)


@pytest.mark.parametrize("s", [4, 11, 23])
def test_spatial_norm_matches_jax(s):
    # 32 groups, eps 1e-6; zq nearest-resized from s frames to 11
    run_both(JU.SpatialNorm(64, 6), PU.SpatialNorm(64, 6), _x(c=64),
             _x(t=s, c=6, seed=2))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mix,index", [(0.5, (1, 0)), (0.3, (0, 0))])
def test_dual_transformer_matches_jax(fused, mix, index):
    c, heads, hd, cl = 32, 4, 8, (5, 7)
    x = _x(c=c)
    ctx = _x(t=sum(cl), c=16, seed=3)
    jm = JU.DualTransformer1D(c, heads, hd, cross_attention_dim=16,
                              norm_num_groups=8, mix_ratio=mix,
                              condition_lengths=cl,
                              transformer_index_for_condition=index)
    pm = PU.DualTransformer1D(c, heads, hd, cross_attention_dim=16,
                              norm_num_groups=8, mix_ratio=mix,
                              condition_lengths=cl,
                              transformer_index_for_condition=index)
    jargs = (jnp.asarray(x), jnp.asarray(ctx))
    tree = fill(flax_shapes(jm, *jargs), seed=4)
    load(pm, tree)
    PU.set_use_fused(pm, fused)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert_close(got, jm.apply(to_jax(tree), *jargs), atol=TOL, rtol=TOL)
    assert_tree_equal(to_flax_params(pm), tree)
