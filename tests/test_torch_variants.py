"""The VITS variants' inference in the port against the JAX package: the
stochastic duration predictor (both directions, the NLL with its posterior
draw e_q injected) and ``VITS.infer`` for (sdp, residual flow), (conv,
residual flow) and (sdp, transformer flow), with zero prior noise and the
duration predictor's draw injected: the test computes JAX's draw
``normal(fold_in(noise_key, 3), (B, Tx, 2))`` and hands it to the port,
which scales it by 0.8 as JAX does. float32; content atol 1e-4, frame
counts exactly equal, NLL rel 1e-5. The end-to-end ``synthesize`` is in
test_torch_variants_synthesize.py.

Weights: the JAX training forward's parameter tree (it holds the
posterior flows' ``post_*`` leaves and the flow), filled from a numpy seed
and carried across by ``from_flax_params``. The widths are the smallest
that run every branch: 2 flows, 2 transformer-flow layers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models.duration import (
    StochasticDurationPredictor as JSDP)
from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.models.duration import StochasticDurationPredictor
from diff_vits_tpu_torch.models.vits import VITS
from diff_vits_tpu_torch.utils.convert import convert_tree
from test_torch_common import (
    assert_close, fill, flax_shapes, load, tiny_configs, to_jax)

torch.set_num_threads(2)

N_VOCAB = 40
B, TX, S, TY, MAX_LEN = 3, 9, 12, 20, 48
VARIANTS = {
    "sdp_residual": dict(duration_predictor="sdp", use_flow=True),
    "conv_residual": dict(duration_predictor="conv", use_flow=True),
    "sdp_transformer": dict(duration_predictor="sdp", use_flow=True,
                            use_transformer_flow=True),
}


def variant_configs(**change):
    """(JAX VitsConfig, port VitsConfig) of the tiny model with ``change``
    and 2 flows of 2 transformer layers."""
    jcfg, pcfg = tiny_configs()
    change = dict(n_flow_layer=2, n_layers_trans_flow=2, **change)
    return (dataclasses.replace(jcfg.vits, **change),
            dataclasses.replace(pcfg.vits, **change))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, N_VOCAB, (B, TX)).astype(np.int32),
            np.array([TX, 5, 2], np.int32),
            rng.normal(size=(B, S, 100)).astype(np.float32),
            np.array([S, S, 6], np.int32),
            rng.integers(0, 11, (B, TX)).astype(np.int32),
            rng.integers(0, 3, (B, TX)).astype(np.int32))


def _training_tree(jm, seed):
    """The JAX training forward's parameters (every leaf, the SDP's
    posterior ``post_*`` included), filled from ``seed``."""
    text, lengths, refer, refer_lengths, tone, lang = map(jnp.asarray,
                                                          _batch(0))
    spec = jnp.zeros((B, TY, 100))
    spec_lengths = jnp.array([TY, 15, 8])
    shapes = flax_shapes(jm, text, lengths, spec, spec_lengths, tone, lang,
                         rngs_noise_key=jax.random.PRNGKey(1))
    return fill(shapes, seed=seed)


def _check_no_ceil_tie(pm, targs, dur_noise):
    """Frame counts are ceil(exp(logw)): a duration within 1e-4 of an
    integer could round apart between the packages (then pick another
    seed)."""
    logw = []
    hook = pm.dp.register_forward_hook(lambda m, a, out: logw.append(out))
    try:
        pm.predict_lengths(*targs, dur_noise=dur_noise)
    finally:
        hook.remove()
    lengths = targs[1].numpy()
    w = np.exp(logw[0][..., 0].numpy())
    kept = np.arange(TX)[None] < lengths[:, None]
    gap = np.abs(w - np.round(w))[kept].min()
    assert gap > 1e-4, f"a duration is {gap:.1e} from an integer"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_vits_infer_matches_jax(name):
    jcfg, pcfg = variant_configs(**VARIANTS[name])
    jm = JVITS(N_VOCAB, jcfg)
    tree = _training_tree(jm, seed=11)
    pm = load(VITS(N_VOCAB, pcfg, device="cpu"), tree)
    arrays = _batch(seed=3)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 3),
                                       (B, TX, 2)))
    ref_c, ref_len = jax.jit(lambda p, *a: jm.apply(
        p, *a, noise_key=key, noise_scale=0.0, max_len=MAX_LEN,
        method=JVITS.infer))(to_jax(tree), *map(jnp.asarray, arrays))
    targs = list(map(torch.from_numpy, arrays))
    dur_noise = torch.from_numpy(noise)
    with torch.no_grad():
        _check_no_ceil_tie(pm, targs, dur_noise)
        content, out_len = pm.infer(*targs, noise_scale=0.0, max_len=MAX_LEN,
                                    dur_noise=dur_noise)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert content.shape == (B, MAX_LEN, pcfg.inter_channels)
    assert_close(content, ref_c, 1e-4)


def _sdp_inputs(seed):
    rng = np.random.default_rng(seed)
    t, c, gin = 11, 16, 8
    mask = (np.arange(t)[None] < np.array([[11], [7]])).astype(
        np.float32)[..., None]
    x = rng.normal(size=(2, t, c)).astype(np.float32)
    w = (rng.integers(1, 6, (2, t, 1)) * mask).astype(np.float32)
    g = rng.normal(size=(2, 1, gin)).astype(np.float32)
    return x, mask, w, g


def test_stochastic_duration_predictor_both_directions_match_jax():
    x, mask, w, g = _sdp_inputs(seed=2)
    jm = JSDP(16, 192, 3, 0.5, 4, gin_channels=8)
    key = jax.random.PRNGKey(7)
    j = list(map(jnp.asarray, (x, mask)))
    tree = fill(flax_shapes(jm, *j, w=jnp.asarray(w), g=jnp.asarray(g),
                            rng_key=key), seed=4)
    assert {"post_pre", "post_convs", "post_proj", "post_flow_pre",
            "post_flow_3"} <= set(tree)
    pm = StochasticDurationPredictor(16, 192, 3, 0.5, 4, gin_channels=8,
                                     device="cpu")
    sd = convert_tree(tree)
    assert set(sd) == set(pm.state_dict())
    load(pm, tree)
    t = list(map(torch.from_numpy, (x, mask)))
    tw, tg = torch.from_numpy(w), torch.from_numpy(g)

    # forward: the NLL, with the posterior draw e_q that JAX takes from
    # split(rng_key, 1)[0]
    nll = jm.apply(to_jax(tree), *j, w=jnp.asarray(w), g=jnp.asarray(g),
                   rng_key=key)
    e_q = np.array(jax.random.normal(jax.random.split(key, 1)[0],
                                     (2, 11, 2)))
    # reverse: log durations from z = normal(rng_key) * noise_scale
    logw = jm.apply(to_jax(tree), *j, g=jnp.asarray(g), reverse=True,
                    noise_scale=0.8, rng_key=key)
    z = np.array(jax.random.normal(key, (2, 11, 2)))
    with torch.no_grad():
        port_nll = pm(*t, w=tw, g=tg, noise=torch.from_numpy(e_q))
        port_logw = pm(*t, g=tg, reverse=True, noise_scale=0.8,
                       noise=torch.from_numpy(z))
    assert port_nll.shape == (2,)
    assert_close(port_nll, nll, 0.0, rtol=1e-5)
    assert port_logw.shape == (2, 11, 1)
    assert_close(port_logw, logw, 1e-4)
