"""The bv2 phoneme prosody VAE in the port against the JAX package at
float32: ``group_by_alignment`` / ``expand_by_alignment`` on a hard
alignment (exactly the matmuls' sums: atol 1e-6), ``PhonemeVAE.__call__``
and ``infer`` with JAX's draws injected (prosody atol 1e-4, loss_kl_ph
rel 1e-5), and ``VITS.forward`` / ``infer`` with ``use_phoneme_vae`` for
the model3 prior (unet) and the sdp + residual-flow variant, held as
tests/test_torch_train_variants.py and test_torch_variants.py hold the
variants: JAX's deterministic mode (no noise key, the stochastic
predictor's draw from PRNGKey(0) injected), content atol 1e-4, the three
losses within atol 1e-4 + rtol 1e-5, equal frame counts.

Weights: the JAX modules' trees (the training forward's, for VITS), filled
from a numpy seed and carried across by ``convert_tree`` (tiny widths: 16
latent and 32 hidden channels, 2 flows; the prior encoder's 8 heads are 4
wide)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.core import masking as jmask
from diff_vits_tpu.models import phoneme_vae as jvae
from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.core import masking
from diff_vits_tpu_torch.models import phoneme_vae as tvae
from diff_vits_tpu_torch.models.vits import VITS
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax
from test_torch_train import N_VOCAB, batch
from test_torch_train_variants import jax_dur_noise
from test_torch_variants import (
    MAX_LEN, _batch, _check_no_ceil_tie, _training_tree, variant_configs)

torch.set_num_threads(2)

B, TX, TY, C, H, GIN = 3, 7, 20, 16, 32, 16


def _alignment(seed):
    """A hard monotonic path [B, TY, TX] over ragged lengths (item 2 keeps
    2 phones, one of them of zero frames) and its text keep mask."""
    rng = np.random.default_rng(seed)
    x_len = np.array([TX, 5, 2])
    dur = rng.integers(0, 5, (B, TX)).astype(np.float32)
    dur[2, 1] = 0.0
    x_keep = (np.arange(TX)[None] < x_len[:, None]).astype(np.float32)
    dur *= x_keep
    y_len = np.minimum(dur.sum(1), TY).astype(np.int32)
    y_keep = (np.arange(TY)[None] < y_len[:, None]).astype(np.float32)
    attn = np.array(jmask.generate_path(
        jnp.asarray(dur), jnp.asarray(y_keep[:, :, None] * x_keep[:, None])))
    return attn, x_keep[..., None]


def test_group_and_expand_by_alignment_match_jax():
    attn, _ = _alignment(0)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(B, TY, C)).astype(np.float32)
    ph = rng.normal(size=(B, TX, C)).astype(np.float32)
    assert attn.sum() > 0 and (attn.sum(1) == 0).any()   # empty segments
    assert_close(tvae.group_by_alignment(torch.from_numpy(z),
                                         torch.from_numpy(attn)),
                 jvae.group_by_alignment(jnp.asarray(z), jnp.asarray(attn)),
                 1e-6)
    assert_close(tvae.expand_by_alignment(torch.from_numpy(ph),
                                          torch.from_numpy(attn)),
                 jvae.expand_by_alignment(jnp.asarray(ph), jnp.asarray(attn)),
                 1e-6)


def _vae_case(seed):
    attn, x_mask = _alignment(seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(B, TY, C)).astype(np.float32)
    x_h = rng.normal(size=(B, TX, H)).astype(np.float32) * x_mask
    g = rng.normal(size=(B, 1, GIN)).astype(np.float32)
    jm = jvae.PhonemeVAE(C, H, n_flow_layer=2, gin_channels=GIN)
    args = tuple(map(jnp.asarray, (z, attn, x_h, x_mask, g)))
    tree = fill(flax_shapes(jm, *args, noise_key=jax.random.PRNGKey(0)),
                seed=seed + 2)
    pm = load(tvae.PhonemeVAE(C, H, n_flow_layer=2, gin_channels=GIN,
                              device="cpu"), tree)
    return jm, tree, pm, (z, attn, x_h, x_mask, g)


def test_phoneme_vae_training_path_matches_jax_with_the_draw_injected():
    jm, tree, pm, arrays = _vae_case(3)
    key = jax.random.PRNGKey(7)
    prosody, kl = jax.jit(lambda p, *a: jm.apply(p, *a, noise_key=key))(
        to_jax(tree), *map(jnp.asarray, arrays))
    # PhEncoder's draw (phoneme_vae.py:59): normal(key, m.shape)
    noise = np.array(jax.random.normal(key, (B, TX, C)))
    with torch.no_grad():
        got, got_kl = pm(*map(torch.from_numpy, arrays),
                         noise=torch.from_numpy(noise))
    assert got.shape == (B, TY, C)
    assert_close(got, prosody, 1e-4)
    assert_close(got_kl, kl, 1e-4, rtol=1e-5)
    # no noise: the posterior mean, as JAX without a key
    ref, ref_kl = jax.jit(jm.apply)(to_jax(tree), *map(jnp.asarray, arrays))
    with torch.no_grad():
        got, got_kl = pm(*map(torch.from_numpy, arrays))
    assert_close(got, ref, 1e-4)
    assert_close(got_kl, ref_kl, 1e-4, rtol=1e-5)


@pytest.mark.parametrize("noise_scale", [0.667, 0.0])
def test_phoneme_vae_infer_matches_jax_with_the_draw_injected(noise_scale):
    jm, tree, pm, (_, attn, x_h, x_mask, g) = _vae_case(5)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda p, *a: jm.apply(
        p, *a, noise_key=key, noise_scale=noise_scale,
        method=jvae.PhonemeVAE.infer))(
            to_jax(tree), *map(jnp.asarray, (attn, x_h, x_mask, g)))
    noise = np.array(jax.random.normal(key, (B, TX, C)))   # :141
    targs = list(map(torch.from_numpy, (attn, x_h, x_mask, g)))
    with torch.no_grad():
        got = pm.infer(*targs[:3], g=targs[3], noise_scale=noise_scale,
                       noise=torch.from_numpy(noise))
        # noise scale 0 draws nothing: the prior mean, as JAX's * 0
        drawn = pm.infer(*targs[:3], g=targs[3], noise_scale=noise_scale,
                         generator=torch.Generator().manual_seed(0))
    assert_close(got, ref, 1e-4)
    if noise_scale == 0.0:
        assert torch.equal(drawn, got)
    else:
        assert not torch.allclose(drawn, got)


def _bv2(**change):
    return variant_configs(use_phoneme_vae=True, **change)


BV2 = {"unet": {}, "sdp_residual": dict(duration_predictor="sdp",
                                        use_flow=True)}


@pytest.mark.parametrize("name", list(BV2))
def test_vits_training_forward_with_the_phoneme_vae_matches_jax(name):
    jcfg, pcfg = _bv2(**BV2[name])
    arrays, _, _ = batch()
    arrays = arrays[:4] + arrays[6:]              # no prompt: the prior only
    jm = JVITS(N_VOCAB, jcfg)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=31)
    assert "phoneme_vae" in tree
    pm = load(VITS(N_VOCAB, pcfg, device="cpu"), tree)
    ref_c, ref_len, (ref_dur, ref_kl, ref_kl_ph) = jax.jit(jm.apply)(
        to_jax(tree), *map(jnp.asarray, arrays))
    kw = ({"dur_noise": torch.from_numpy(jax_dur_noise(arrays))}
          if name.startswith("sdp") else {})
    with torch.no_grad():
        content, lengths, (l_length, loss_kl, loss_kl_ph) = pm(
            *map(torch.from_numpy, arrays), **kw)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert float(loss_kl_ph) != 0.0
    assert_close(content, ref_c, 1e-4)
    assert_close(l_length, ref_dur, 1e-4, rtol=1e-5)
    assert_close(loss_kl, ref_kl, 1e-4, rtol=1e-5)
    assert_close(loss_kl_ph, ref_kl_ph, 1e-4, rtol=1e-5)


def test_vits_infer_with_the_phoneme_vae_matches_jax():
    jcfg, pcfg = _bv2(**BV2["sdp_residual"])
    jm = JVITS(N_VOCAB, jcfg)
    tree = _training_tree(jm, seed=13)
    pm = load(VITS(N_VOCAB, pcfg, device="cpu"), tree)
    arrays = _batch(seed=3)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 3),
                                       (3, arrays[0].shape[1], 2)))
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
    assert content.shape == (3, MAX_LEN, pcfg.inter_channels)
    assert_close(content, ref_c, 1e-4)
    # the prosody takes part: the same weights without the VAE differ
    pm_plain = load(VITS(N_VOCAB, dataclasses.replace(
        pcfg, use_phoneme_vae=False), device="cpu"),
        {k: v for k, v in tree.items() if k != "phoneme_vae"})
    with torch.no_grad():
        plain, _ = pm_plain.infer(*targs, noise_scale=0.0, max_len=MAX_LEN,
                                  dur_noise=dur_noise)
    assert (plain - content).abs().max() > 1e-3


def test_kl_of_the_phoneme_prior_is_the_masked_mean():
    """loss_kl_ph divides by the kept phones, as the frame KL by frames."""
    rng = np.random.default_rng(2)
    a = [torch.from_numpy(rng.normal(size=(2, 4, 3)).astype(np.float32))
         for _ in range(4)]
    keep = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]],
                        dtype=torch.float32)[..., None]
    assert_close(masking.kl_loss(*a, keep),
                 jmask.kl_loss(*(jnp.asarray(x.numpy()) for x in a),
                               jnp.asarray(keep.numpy())), 1e-6, rtol=1e-6)
