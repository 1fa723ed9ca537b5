"""The port's ConvReluNorm, ResBlock1 / ResBlock2, every option of the
VITS MultiHeadAttention and FFN, and the Decoder against the JAX package
(CPU, float32, atol = rtol = 1e-5).

Weights: the flax tree from ``jax.eval_shape`` of ``init``, filled from a
numpy seed, carried by ``convert_tree`` (and back by ``to_flax_params``,
bit for bit). Masks drop the tails of some items, so masked scores and
padded frames take part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import layers as J
from diff_vits_tpu_torch.nn import layers as P
from diff_vits_tpu_torch.utils.convert import to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)
TOL = 1e-5
B, T, C = 3, 11, 16


def _mask(t=T, lengths=(11, 7, 1)):
    return (np.arange(t)[None] < np.array(lengths)[:, None]).astype(
        np.float32)[..., None]


def _x(t=T, c=C, seed=0):
    return np.random.default_rng(seed).normal(size=(B, t, c)).astype(
        np.float32)


def run_both(jm, pm, *arrays, seed=0, atol=TOL):
    """Fill jm's tree, load it into pm, run both on ``arrays`` (None stays
    None); check the outputs and the round trip of the tree."""
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    tree = fill(flax_shapes(jm, *jargs), seed=seed)
    load(pm, tree)
    with torch.no_grad():
        got = pm(*[None if a is None else torch.from_numpy(a)
                   for a in arrays])
    want = jm.apply(to_jax(tree), *jargs)
    assert_close(got, want, atol=atol, rtol=atol)
    assert_tree_equal(to_flax_params(pm), tree)
    return tree


def assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k, v in want.items():
        if isinstance(v, dict):
            assert_tree_equal(got[k], v, f"{path}/{k}")
        else:
            assert got[k].shape == v.shape, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], v, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("k", [3, 4])
def test_conv_relu_norm_matches_jax(k):
    # k = 4: flax SAME puts the odd padding frame on the right
    run_both(J.ConvReluNorm(12, C, 12, k, 2, 0.1),
             P.ConvReluNorm(12, C, 12, k, 2, 0.1), _x(c=12), _mask())


def test_conv_relu_norm_projection_starts_at_zero():
    m = P.ConvReluNorm(12, C, 12, 3, 2)
    assert float(m.proj.weight.detach().abs().max()) == 0.0
    x = torch.from_numpy(_x(c=12))
    mask = torch.from_numpy(_mask())
    torch.testing.assert_close(m(x, mask), x * mask, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k,dil", [(3, (1, 3, 5)), (5, (1, 2))])
def test_resblock1_matches_jax(k, dil, masked):
    run_both(J.ResBlock1(C, k, dil), P.ResBlock1(C, k, dil), _x(),
             _mask() if masked else None)


@pytest.mark.parametrize("masked", [True, False])
def test_resblock2_matches_jax(masked):
    run_both(J.ResBlock2(C, 3, (1, 3)), P.ResBlock2(C, 3, (1, 3)), _x(),
             _mask() if masked else None)


def _attn_mask(tq=T, tk=T, lq=(11, 7, 1), lk=(11, 7, 1)):
    return _mask(tq, lq)[:, None, :, :] * _mask(tk, lk)[:, None, None, :, 0]


MHA_CASES = {
    # name: (JAX / port kwargs, heads, keys from c, mask kind)
    "production": (dict(window_size=4), 2, False, "lengths"),
    "production_no_mask": (dict(window_size=4), 2, False, None),
    "window_3_heads_4": (dict(window_size=3), 4, False, "lengths"),
    "long_window": (dict(window_size=20), 2, False, "lengths"),
    "per_head_tables": (dict(window_size=4, heads_share=False), 2, False,
                        "lengths"),
    "per_head_tables_4": (dict(window_size=2, heads_share=False), 4, False,
                          None),
    "no_window": (dict(window_size=None), 2, False, "lengths"),
    "proximal_bias": (dict(window_size=4, proximal_bias=True), 2, False,
                      "lengths"),
    "proximal_no_window": (dict(window_size=None, proximal_bias=True), 2,
                           False, "causal"),
    "block_length": (dict(window_size=4, block_length=2), 2, False,
                     "lengths"),
    "block_length_no_mask": (dict(window_size=4, block_length=2), 2, False,
                             None),
    "proximal_init": (dict(window_size=None, proximal_init=True), 2, False,
                      "causal"),
    "enc_dec": (dict(window_size=None), 2, True, "cross"),
    "enc_dec_no_mask": (dict(window_size=None), 4, True, None),
}


@pytest.mark.parametrize("name", list(MHA_CASES))
def test_multi_head_attention_matches_jax(name):
    kw, heads, cross, mask_kind = MHA_CASES[name]
    x = _x()
    c = _x(t=7, seed=1) if cross else x
    mask = {"lengths": _attn_mask(),
            "causal": np.tril(np.ones((T, T), np.float32))[None, None],
            "cross": _attn_mask(tk=7, lk=(7, 3, 5)),
            None: None}[mask_kind]
    jm = J.MultiHeadAttention(C, 12, heads, **kw)
    pm = P.MultiHeadAttention(C, 12, heads, **kw)
    jargs = [jnp.asarray(x), jnp.asarray(c),
             None if mask is None else jnp.asarray(mask)]
    tree = fill(flax_shapes(jm, *jargs), seed=3)
    load(pm, tree)
    want = jm.apply(to_jax(tree), *jargs)
    with torch.no_grad():
        if mask_kind == "lengths" and not cross:
            # the Encoder's call: per-item lengths (the production route
            # when the options allow it)
            got = pm(torch.from_numpy(x), torch.tensor([11, 7, 1]))
        else:
            got = pm(torch.from_numpy(x),
                     c=torch.from_numpy(c) if cross else None,
                     attn_mask=None if mask is None
                     else torch.from_numpy(mask))
    # a query row of item 2 beyond its length keeps no key: both packages
    # give it the uniform softmax of -1e4 scores
    assert_close(got, want, atol=TOL, rtol=TOL)
    assert_tree_equal(to_flax_params(pm), tree)


def test_production_attention_keeps_its_parameters():
    """The Encoder's attention keeps its names and shapes: the tables are
    [1, 2w+1, k]; heads_share=False makes them [H, 2w+1, k]; no window,
    none."""
    sd = P.MultiHeadAttention(32, 32, 2, window_size=4).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "conv_q.weight": (32, 32), "conv_q.bias": (32,),
        "conv_k.weight": (32, 32), "conv_k.bias": (32,),
        "conv_v.weight": (32, 32), "conv_v.bias": (32,),
        "conv_o.weight": (32, 32), "conv_o.bias": (32,),
        "emb_rel_k": (1, 9, 16), "emb_rel_v": (1, 9, 16)}
    assert P.MultiHeadAttention(32, 32, 2, 4, heads_share=False) \
        .emb_rel_k.shape == (2, 9, 16)
    assert "emb_rel_k" not in P.MultiHeadAttention(32, 32, 2, None) \
        .state_dict()
    m = P.MultiHeadAttention(32, 32, 2, None, proximal_init=True)
    assert torch.equal(m.conv_k.weight, m.conv_q.weight)
    assert torch.equal(m.conv_k.bias, m.conv_q.bias)
    assert m._production() is False
    assert P.MultiHeadAttention(32, 32, 2, 4)._production()


def test_general_attention_dropout_draws_from_the_generator():
    m = P.MultiHeadAttention(C, C, 2, None, p_dropout=0.5).train()
    x = torch.from_numpy(_x())
    a = m(x, attn_mask=torch.ones(1, 1, T, T),
          generator=torch.Generator().manual_seed(4))
    b = m(x, attn_mask=torch.ones(1, 1, T, T),
          generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        m(x, attn_mask=torch.ones(1, 1, T, T))


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("activation,causal", [(None, False), ("gelu", False),
                                               (None, True), ("gelu", True)])
def test_ffn_matches_jax(k, activation, causal):
    run_both(J.FFN(12, 20, k, activation=activation, causal=causal),
             P.FFN(C, 12, 20, k, activation=activation, causal=causal),
             _x(), _mask())


def test_ffn_causal_output_ignores_the_future():
    m = P.FFN(C, C, 8, 3, causal=True)
    x = torch.from_numpy(_x())
    ones = torch.ones(B, T, 1)
    y = m(x, ones)
    x2 = x.clone()
    x2[:, 6:] += 1.0
    torch.testing.assert_close(m(x2, ones)[:, :6], y[:, :6], rtol=0, atol=0)


@pytest.mark.parametrize("proximal_bias", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_decoder_matches_jax(proximal_bias, k):
    x, h = _x(), _x(t=7, seed=2)
    run_both(J.Decoder(C, 24, 2, 2, kernel_size=k,
                       proximal_bias=proximal_bias),
             P.Decoder(C, 24, 2, 2, kernel_size=k,
                       proximal_bias=proximal_bias),
             x, _mask(), h, _mask(7, (7, 3, 5)), seed=5)
