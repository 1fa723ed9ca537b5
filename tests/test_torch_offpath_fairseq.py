"""The port's fairseq layers against the JAX package (CPU, float32): the
sinusoidal positions, the decode KV cache, every ``OPERATIONS_ENCODER``
entry (1-15) and ``ConvAttentionLayer``.

Feed-forward layers at atol = rtol = 1e-5; the Bi-LSTM (code 12) at 1e-4
over T = 13. Keep masks drop the tails of some items. The Gaussian layer's
``tao`` is set to 2-4 (the numpy fill draws small values, which would make
tao^-4 enormous).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import fairseq as J
from diff_vits_tpu_torch.nn import fairseq as P
from diff_vits_tpu_torch.utils.convert import to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax
from test_torch_offpath_layers import assert_tree_equal

torch.set_num_threads(2)
TOL = 1e-5
B, T, C = 3, 13, 16


def _keep(t=T, lengths=(13, 9, 4)):
    return (np.arange(t)[None] < np.array(lengths)[:, None]).astype(
        np.float32)[..., None]


@pytest.mark.parametrize("dim", [16, 15])
def test_sinusoidal_positions_match_jax(dim):
    tokens = np.array([[5, 9, 3, 0, 0], [7, 0, 0, 0, 0], [0, 4, 4, 0, 2]])
    got = P.SinusoidalPositionalEmbedding(dim, 0)(torch.from_numpy(tokens))
    want = J.SinusoidalPositionalEmbedding(dim, 0).apply(
        {}, jnp.asarray(tokens))
    assert_close(got, want, atol=TOL, rtol=TOL)
    pos = np.array([[0, 1, 2, 30], [3, 0, 5, 1]])
    assert_close(P.sinusoidal_positional_embedding(torch.from_numpy(pos),
                                                   dim, 1),
                 J.sinusoidal_positional_embedding(jnp.asarray(pos), dim, 1),
                 atol=TOL, rtol=TOL)


def test_incremental_attention_matches_jax_step_by_step():
    rng = np.random.default_rng(10)
    b, h, t, d = 2, 4, 7, 8
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    cache = P.init_kv_cache(b, t, h, d)
    jcache = J.init_kv_cache(b, t, h, d)
    for i in range(t):
        s = slice(i, i + 1)
        o, cache = P.incremental_attention_step(
            *(torch.from_numpy(a[:, :, s]) for a in (q, k, v)), cache)
        jo, jcache = J.incremental_attention_step(
            *(jnp.asarray(a[:, :, s]) for a in (q, k, v)), jcache)
        assert_close(o, jo, atol=TOL, rtol=TOL)
        assert cache["index"] == int(jcache["index"]) == i + 1
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))


def _registry_tree(code, jm, x, keep):
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(keep)),
                seed=code)
    if code == 13:
        tree["tao"] = np.array([3.0], np.float32)
    return tree


@pytest.mark.parametrize("code", list(range(1, 16)))
def test_operations_encoder_entry_matches_jax(code):
    rng = np.random.default_rng(code)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    keep = _keep()
    jm = J.OPERATIONS_ENCODER[code](C, 0.1)
    pm = P.OPERATIONS_ENCODER[code](C, 0.1)
    assert type(pm).__name__ == type(jm).__name__
    tree = _registry_tree(code, jm, x, keep)
    load(pm, tree)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(keep))
    want = jm.apply(to_jax(tree), jnp.asarray(x), jnp.asarray(keep))
    tol = 1e-4 if code == 12 else TOL
    assert_close(got, want, atol=tol, rtol=tol)
    assert_tree_equal(to_flax_params(pm), tree)


@pytest.mark.parametrize("heads,tao", [(1, 2.0), (2, 4.0)])
def test_gaussian_attention_without_bias_and_multi_head(heads, tao):
    rng = np.random.default_rng(heads)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    keep = _keep()
    for gaus_bias in (False, True):
        jm = J.EncGausSALayer(heads, gaus_bias=gaus_bias, gaus_tao=tao)
        pm = P.EncGausSALayer(C, heads, gaus_bias=gaus_bias, gaus_tao=tao)
        tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(keep)))
        if gaus_bias:
            assert float(pm.tao.detach()[0]) == tao
            tree["tao"] = np.full((heads,), tao, np.float32)
        load(pm, tree)
        with torch.no_grad():
            got = pm(torch.from_numpy(x), torch.from_numpy(keep))
        assert_close(got, jm.apply(to_jax(tree), jnp.asarray(x),
                                   jnp.asarray(keep)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("chunk", [3, 101])
def test_local_attention_band_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    keep = _keep()
    jm = J.EncLocalSALayer(2, 0.0, chunk_size=chunk)
    pm = P.EncLocalSALayer(C, 2, chunk_size=chunk)
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(keep)))
    load(pm, tree)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(keep))
    assert_close(got, jm.apply(to_jax(tree), jnp.asarray(x),
                               jnp.asarray(keep)), atol=TOL, rtol=TOL)


def test_lstm_layer_runs_the_backward_direction_over_the_padding():
    """JAX's nn.RNN(reverse=True) without lengths starts the backward
    direction at the last padded frame; the unpacked Bi-LSTM does too, so
    a valid frame's output changes with what the padding holds."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, C)).astype(np.float32)
    keep = _keep(8, (5,))
    jm = J.EncLSTMLayer()
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(keep)))
    pm = load(P.EncLSTMLayer(C), tree)
    x2 = x.copy()
    x2[:, 5:] = rng.normal(size=(1, 3, C))     # other padding frames
    for a in (x, x2):
        with torch.no_grad():
            got = pm(torch.from_numpy(a), torch.from_numpy(keep))
        assert_close(got, jm.apply(to_jax(tree), jnp.asarray(a),
                                   jnp.asarray(keep)), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        a = pm(torch.from_numpy(x), torch.from_numpy(keep))[:, :5]
        b = pm(torch.from_numpy(x2), torch.from_numpy(keep))[:, :5]
    assert float((a - b).abs().max()) > 1e-4


@pytest.mark.parametrize("masked,constrained", [(False, False), (True, False),
                                                (True, True)])
def test_conv_attention_layer_matches_jax(masked, constrained):
    rng = np.random.default_rng(4)
    b, tq, tk, c, hidden = 2, 7, 9, 12, 8
    x = rng.normal(size=(b, tq, c)).astype(np.float32)
    key = rng.normal(size=(b, tk, hidden)).astype(np.float32)
    value = rng.normal(size=(b, tk, hidden)).astype(np.float32)
    keep = np.ones((b, tk), bool)
    keep[1, 6:] = False
    keep_arg = keep if masked else None
    cons = None
    if constrained:
        cons = np.zeros((b, tq, tk), bool)
        cons[0, 3] = True          # a query that keeps no key: zeros
        cons[1, :, 0] = True
    jm = J.ConvAttentionLayer(hidden)
    pm = P.ConvAttentionLayer(c, hidden)
    jargs = [jnp.asarray(x), jnp.asarray(key), jnp.asarray(value),
             None if keep_arg is None else jnp.asarray(keep_arg),
             None if cons is None else jnp.asarray(cons)]
    tree = fill(flax_shapes(jm, *jargs), seed=1)
    load(pm, tree)
    with torch.no_grad():
        out, p, logits = pm(
            *(torch.from_numpy(a) for a in (x, key, value)),
            None if keep_arg is None else torch.from_numpy(keep_arg),
            None if cons is None else torch.from_numpy(cons))
    jout, jp, jlogits = jm.apply(to_jax(tree), *jargs)
    for got, want in ((out, jout), (p, jp)):
        assert bool(torch.isfinite(got).all())
        assert_close(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    if constrained:
        assert float(p[0, 3].abs().max()) == 0.0
    assert_tree_equal(to_flax_params(pm), tree)


def test_layers_in_training_mode_draw_from_the_generator():
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(0))
    keep = torch.from_numpy(_keep())
    for code in (2, 9, 11, 12, 13):
        m = P.OPERATIONS_ENCODER[code](C, 0.3).train()
        a = m(x, keep, generator=torch.Generator().manual_seed(1))
        b = m(x, keep, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        with torch.no_grad():
            assert not torch.equal(a, m.eval()(x, keep))
