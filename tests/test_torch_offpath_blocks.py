"""The port's UNet block zoo against the JAX package (CPU, float32,
atol = rtol = 1e-5): the resamplers at odd and even T (and against the
numpy / torch oracles of the JAX package's own tests), the attention
variants, the full-option resnet, the mid blocks and
``KAttentionBlock1D``, every output compared (the factories' blocks are
in ``test_torch_offpath_factories.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import unet1d_blocks as Z
from diff_vits_tpu_torch.nn import unet1d_blocks as P
from diff_vits_tpu_torch.nn.unet1d import set_use_fused
from diff_vits_tpu_torch.utils.convert import to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax
from test_torch_offpath_layers import assert_tree_equal

torch.set_num_threads(2)
TOL = 1e-5
B, T, S = 2, 24, 7


def _r(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flat(out):
    """Arrays of a nested output, None kept as a marker."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _compare(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or isinstance(w, float):
            assert g is None or isinstance(g, float), (g, w)
            continue
        assert tuple(g.shape) == tuple(w.shape)
        assert_close(g, w, atol=TOL, rtol=TOL)


def _to_torch(a):
    if isinstance(a, list):
        return [_to_torch(x) for x in a]
    return None if a is None else torch.from_numpy(a)


def _to_jax(a):
    if isinstance(a, list):
        return [_to_jax(x) for x in a]
    return None if a is None else jnp.asarray(a)


def run_both(jm, pm, *arrays, seed=0, fused=True):
    """Fill jm's tree, load it into pm; run both on ``arrays`` (lists are
    copied for each side: the up blocks pop their skips)."""
    tree = fill(flax_shapes(jm, *_to_jax(list(arrays))), seed=seed)
    load(pm, tree)
    set_use_fused(pm, fused)
    with torch.no_grad():
        got = pm(*_to_torch(list(arrays)))
    _compare(got, jm.apply(to_jax(tree), *_to_jax(list(arrays))))
    assert_tree_equal(to_flax_params(pm), tree)
    return got


# -- resamplers ---------------------------------------------------------------

def _upfirdn1d_np(x, k, up=1, down=1, pad=(0, 0)):
    """The JAX test's numpy oracle (test_block_zoo.py:373-389)."""
    b, t, c = x.shape
    if up > 1:
        z = np.zeros((b, t * up, c), x.dtype)
        z[:, ::up, :] = x
        x = z
    x = np.pad(x, ((0, 0), pad, (0, 0)))
    t2 = x.shape[1] - len(k) + 1
    out = np.zeros((b, t2, c), np.float32)
    for i in range(len(k)):
        out += k[i] * x[:, i:i + t2, :]
    return out[:, ::down, :]


RESAMPLERS = ["fir_downsample_1d", "fir_upsample_1d", "k_downsample_1d",
              "k_upsample_1d", "avg_pool_1d", "nearest_upsample_1d"]


@pytest.mark.parametrize("t", [24, 23, 5])
@pytest.mark.parametrize("name", RESAMPLERS)
def test_resampler_matches_jax(name, t):
    x = _r(B, t, 5, seed=t)
    got = getattr(P, name)(torch.from_numpy(x))
    want = getattr(Z, name)(jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t", [24, 23])
def test_fir_resamplers_match_the_numpy_oracle(t):
    x = _r(B, t, 5, seed=1)
    k = np.array([1, 3, 3, 1], np.float32)
    np.testing.assert_allclose(
        P.fir_downsample_1d(torch.from_numpy(x)).numpy(),
        _upfirdn1d_np(x, k / k.sum(), down=2, pad=(1, 1)), rtol=TOL,
        atol=1e-6)
    got = P.fir_upsample_1d(torch.from_numpy(x))
    assert got.shape == (B, 2 * t, 5)
    np.testing.assert_allclose(
        got.numpy(), _upfirdn1d_np(x, k / k.sum() * 2, up=2, pad=(2, 1)),
        rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("t", [24, 23])
def test_k_resamplers_match_torch_convs(t):
    """The JAX test's oracle (test_block_zoo.py:409): reflect pad, then a
    stride-2 conv / transpose conv with the binomial kernel."""
    x = _r(B, t, 5, seed=2)
    xt = torch.from_numpy(x.transpose(0, 2, 1))
    k1 = torch.tensor([1.0, 3.0, 3.0, 1.0]) / 8.0
    idx = torch.arange(5)
    w = torch.zeros(5, 5, 4)
    w[idx, idx] = k1
    pad = torch.nn.functional.pad(xt, (1, 1), mode="reflect")
    down = torch.nn.functional.conv1d(pad, w, stride=2)
    np.testing.assert_allclose(P.k_downsample_1d(torch.from_numpy(x)).numpy(),
                               down.numpy().transpose(0, 2, 1), rtol=TOL,
                               atol=1e-6)
    w2 = torch.zeros(5, 5, 4)
    w2[idx, idx] = k1 * 2.0
    up = torch.nn.functional.conv_transpose1d(pad, w2.transpose(0, 1),
                                              stride=2, padding=3)
    got = P.k_upsample_1d(torch.from_numpy(x))
    assert got.shape == (B, 2 * t, 5)
    np.testing.assert_allclose(got.numpy(), up.numpy().transpose(0, 2, 1),
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1)), (3, 1, (0, 0)),
                                         (2, 3, (-1, 2)), (1, 2, (1, -2))])
def test_upfirdn1d_matches_jax(up, down, pad):
    x = _r(B, 13, 3, seed=3)
    k = np.array([0.5, 1.0, -0.25], np.float32)
    assert_close(P.upfirdn1d(torch.from_numpy(x), k, up, down, pad),
                 Z.upfirdn1d(jnp.asarray(x), k, up, down, pad), atol=TOL,
                 rtol=TOL)


@pytest.mark.parametrize("cls", ["FirUpsample1D", "FirDownsample1D"])
@pytest.mark.parametrize("use_conv", [False, True])
def test_fir_modules_match_jax(cls, use_conv):
    x = _r(B, 13, 8, seed=4)
    jm = getattr(Z, cls)(8, 6, use_conv=use_conv)
    pm = getattr(P, cls)(8, 6, use_conv=use_conv)
    if use_conv:
        run_both(jm, pm, x)
    else:
        assert list(pm.state_dict()) == []
        _compare(pm(torch.from_numpy(x)), jm.apply({}, jnp.asarray(x)))
    kd = P.KDownsample1D()(torch.from_numpy(x))
    assert_close(kd, Z.KDownsample1D().apply({}, jnp.asarray(x)), atol=TOL,
                 rtol=TOL)
    ku = P.KUpsample1D()(torch.from_numpy(x))
    assert_close(ku, Z.KUpsample1D().apply({}, jnp.asarray(x)), atol=TOL,
                 rtol=TOL)


# -- attention and resnet parts ---------------------------------------------

def _bias(s, lengths=(7, 4)):
    keep = (np.arange(s)[None] < np.array(lengths)[:, None])
    return ((1 - keep.astype(np.float32)) * -10000.0)[:, None, :]


LEGACY = {
    "group_norm": (dict(norm_num_groups=4), False, False),
    "spatial_norm": (dict(spatial_norm_dim=6, rescale_output_factor=2.0),
                     False, False),
    "self_bias": (dict(norm_num_groups=4), False, True),
    "cross_layer_norm": (dict(cross_attention_dim=10,
                              cross_attention_norm="layer_norm"), True, True),
    "k_style": (dict(use_bias=False, residual_connection=False,
                     cross_attention_dim=10), True, False),
}


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_attention_matches_jax(name):
    kw, cross, biased = LEGACY[name]
    x = _r(B, T, 32)
    ctx = _r(B, S, 10, seed=1) if cross else None
    temb = _r(B, 5, 6, seed=2) if "spatial_norm_dim" in kw else None
    bias = (_bias(S) if cross else _bias(T, (24, 13))) if biased else None
    run_both(Z.LegacyAttention1D(32, 4, 8, **kw),
             P.LegacyAttention1D(32, 4, 8, **kw), x, ctx, temb, bias)


@pytest.mark.parametrize("only_cross,norm,biased", [
    (False, None, False), (True, None, True), (False, "layer_norm", True)])
def test_added_kv_attention_matches_jax(only_cross, norm, biased):
    x, ctx = _r(B, T, 32), _r(B, S, 10, seed=1)
    kw = dict(norm_num_groups=4, only_cross_attention=only_cross,
              cross_attention_norm=norm)
    run_both(Z.AddedKVAttention1D(32, 4, 8, 10, **kw),
             P.AddedKVAttention1D(32, 4, 8, 10, **kw), x, ctx,
             _bias(S) if biased else None)


RESNETS = {
    "default": dict(),
    "scale_shift_skip_act": dict(time_embedding_norm="scale_shift",
                                 skip_time_act=True),
    "ada_group_gelu": dict(time_embedding_norm="ada_group",
                           non_linearity="gelu", conv_shortcut_bias=False),
    "spatial_mish": dict(time_embedding_norm="spatial", non_linearity="mish"),
    "down_pool": dict(resample="down"),
    "down_fir": dict(resample="down", resample_kernel="fir",
                     use_in_shortcut=True),
    "up_nearest": dict(resample="up", output_scale_factor=2.0),
    "up_fir_groups_out": dict(resample="up", resample_kernel="fir",
                              groups_out=2),
    "conv_out_width": dict(conv_out_channels=24, non_linearity="relu"),
    "no_temb": dict(temb_channels=None),
    "same_width_shortcut": dict(out_channels=16, use_in_shortcut=True),
}


@pytest.mark.parametrize("name", list(RESNETS))
def test_resnet_block_full_matches_jax(name):
    kw = dict(out_channels=32, temb_channels=12, groups=4)
    kw.update(RESNETS[name])
    x = _r(B, 23, 16)
    if kw.get("temb_channels") is None:
        temb = None
    elif kw.get("time_embedding_norm") == "spatial":
        temb = _r(B, 9, 12, seed=1)        # the spatial latent zq
    else:
        temb = _r(B, 12, seed=1)
    groups = kw.pop("groups")
    if kw.get("time_embedding_norm") == "spatial":
        x = _r(B, 23, 32)                 # SpatialNorm's 32 groups
        kw["out_channels"] = 32
    in_ch = x.shape[-1]
    run_both(Z.ResnetBlockFull(in_ch, groups=groups, **kw),
             P.ResnetBlockFull(in_ch, groups=groups, **kw), x, temb)


# -- mid blocks and the K attention block -------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(add_attention=False),
                                dict(time_scale_shift="spatial"),
                                dict(time_scale_shift="scale_shift",
                                     num_layers=2, output_scale_factor=2.0)],
                         ids=["default", "no_attention", "spatial",
                              "scale_shift_2"])
def test_mid_block_matches_jax(kw):
    kw = dict(temb_channels=12, groups=4, attention_head_dim=8, **kw)
    x = _r(B, T, 32)
    temb = (_r(B, 6, 12, seed=1) if kw.get("time_scale_shift") == "spatial"
            else _r(B, 12, seed=1))
    run_both(Z.MidBlock1D(32, **kw), P.MidBlock1D(32, **kw), x, temb)


@pytest.mark.parametrize("only_cross", [False, True])
def test_mid_block_simple_cross_attn_matches_jax(only_cross):
    kw = dict(cross_attention_dim=10, groups=4, attention_head_dim=8,
              only_cross_attention=only_cross, skip_time_act=True,
              cross_attention_norm="layer_norm")
    run_both(Z.MidBlock1DSimpleCrossAttn(32, 12, **kw),
             P.MidBlock1DSimpleCrossAttn(32, 12, **kw), _r(B, T, 32),
             _r(B, 12, seed=1), _r(B, S, 10, seed=2), _bias(S))


@pytest.mark.parametrize("self_attn,cross", [(False, True), (True, True),
                                             (True, False)])
def test_k_attention_block_matches_jax(self_attn, cross):
    kw = dict(cross_attention_dim=10 if cross else None, temb_channels=12,
              add_self_attention=self_attn, group_size=8)
    x, temb = _r(B, T, 32), _r(B, 12, seed=1)
    ctx = _r(B, S, 10, seed=2) if cross else None
    run_both(Z.KAttentionBlock1D(32, 4, 8, **kw),
             P.KAttentionBlock1D(32, 4, 8, **kw), x, ctx, temb,
             _bias(S) if cross else None, _bias(T, (24, 13)))
