"""Port's training forward against the JAX package, at the tiny widths of
``test_torch_common``: ``WN``, ``PosteriorEncoder``, ``kl_divergence`` /
``kl_loss``, the ``GaussianDiffusion`` buffers and ``q_sample``, and
``DiffVits.forward`` (every metric, the x0 prediction and its target) in
the deterministic mode (eval, no generator: zero posterior and MAS noise,
injected t and noise), with the same flax parameter tree carried into the
port. float32, atol 1e-4 (plus rtol 1e-5 on the loss terms: the SNR
weight of small t makes the diffusion loss ~1e3). ``VITS.forward`` and
the gradients are in ``test_torch_train_vits.py`` and
``test_torch_train_unet.py``: one jitted JAX gradient of the whole model
compiles for over a minute on a CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.core import masking as jmask
from diff_vits_tpu.diffusion.schedule import GaussianDiffusion as JGD
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.models.encoders import PosteriorEncoder as JPost
from diff_vits_tpu.nn.layers import WN as JWN
from diff_vits_tpu_torch.core import masking as tmask
from diff_vits_tpu_torch.diffusion.schedule import GaussianDiffusion
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.models.encoders import PosteriorEncoder
from diff_vits_tpu_torch.nn.layers import WN
from test_torch_common import (
    assert_close, fill, flax_shapes, load, tiny_configs, to_jax)

torch.set_num_threads(2)

ATOL = 1e-4
N_VOCAB = 40


@pytest.mark.parametrize("gin,dilation", [(8, 1), (0, 2)])
def test_wn_matches_jax(gin, dilation):
    rng = np.random.default_rng(dilation)
    b, t, h = 3, 17, 16
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([[17], [9], [1]])).astype(
        np.float32)[..., None]
    args = [x, mask] + ([rng.normal(size=(b, 1, gin)).astype(np.float32)]
                        if gin else [])
    jm = JWN(h, 5, dilation, 3, gin_channels=gin)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, args)), seed=gin + 1)
    pm = load(WN(h, 5, dilation, 3, gin_channels=gin), tree)
    with torch.no_grad():
        port = pm(*map(torch.from_numpy, args))
    assert_close(port, jm.apply(to_jax(tree), *map(jnp.asarray, args)), ATOL)


def test_posterior_encoder_matches_jax():
    rng = np.random.default_rng(3)
    b, t = 3, 21
    y = rng.normal(size=(b, t, 100)).astype(np.float32)
    lengths = np.array([21, 13, 2], np.int32)
    g = rng.normal(size=(b, 1, 16)).astype(np.float32)
    jm = JPost(100, 16, 32, 5, 1, 4, gin_channels=16)
    arrays = (y, lengths)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays), g=jnp.asarray(g)),
                seed=5)
    pm = load(PosteriorEncoder(100, 16, 32, 5, 1, 4, gin_channels=16,
                               device="cpu"), tree)
    ref = jm.apply(to_jax(tree), *map(jnp.asarray, arrays), g=jnp.asarray(g))
    with torch.no_grad():
        port = pm(*map(torch.from_numpy, arrays), g=torch.from_numpy(g))
    for p_, r_ in zip(port, ref):      # z = m * mask, m, logs, mask
        assert_close(p_, r_, ATOL)


def test_kl_terms_and_diffusion_buffers_match_jax():
    rng = np.random.default_rng(4)
    z, logs_q, m_p, logs_p = (rng.normal(size=(2, 7, 5)).astype(np.float32)
                              for _ in range(4))
    mask = (np.arange(7)[None] < np.array([[7], [3]])).astype(
        np.float32)[..., None]
    assert_close(tmask.kl_loss(*map(torch.from_numpy,
                                    (z, logs_q, m_p, logs_p, mask))),
                 jmask.kl_loss(*map(jnp.asarray,
                                    (z, logs_q, m_p, logs_p, mask))), 1e-5)
    assert_close(tmask.kl_divergence(*map(torch.from_numpy,
                                          (m_p, logs_p, z, logs_q))),
                 jmask.kl_divergence(*map(jnp.asarray,
                                          (m_p, logs_p, z, logs_q))), 1e-5)
    for steps in (1000, 50):
        port, ref = GaussianDiffusion.create(steps), JGD.create(steps)
        assert port.num_timesteps == ref.num_timesteps == steps
        for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                     "loss_weight"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)))
    x0 = rng.normal(size=(3, 6, 4)).astype(np.float32)
    noise = rng.normal(size=(3, 6, 4)).astype(np.float32)
    t = np.array([0, 417, 999])
    assert_close(GaussianDiffusion.create().q_sample(
        torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise)),
        JGD.create().q_sample(jnp.asarray(x0), jnp.asarray(t),
                              jnp.asarray(noise)), 1e-6)


def batch(seed=6):
    """A ragged training batch (t_x <= t_y per item) and injected t and
    noise, as numpy."""
    rng = np.random.default_rng(seed)
    b, tx, ty, s = 3, 9, 30, 12
    text = rng.integers(1, N_VOCAB, (b, tx)).astype(np.int32)
    text_lengths = np.array([9, 6, 1], np.int32)
    spec = rng.normal(size=(b, ty, 100)).astype(np.float32)
    spec_lengths = np.array([30, 17, 6], np.int32)
    refer = rng.normal(size=(b, s, 100)).astype(np.float32)
    refer_lengths = np.array([12, 12, 5], np.int32)
    tone = rng.integers(0, 11, (b, tx)).astype(np.int32)
    lang = rng.integers(0, 3, (b, tx)).astype(np.int32)
    t = np.array([3, 512, 998], np.int32)
    noise = rng.normal(size=(b, ty, 100)).astype(np.float32)
    return (text, text_lengths, spec, spec_lengths, refer, refer_lengths,
            tone, lang), t, noise


def test_diff_vits_training_forward_matches_jax():
    jcfg, pcfg = tiny_configs()
    arrays, t, noise = batch()
    jm = JDiffVits(jcfg, n_vocab=N_VOCAB)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays),
                            rng=jax.random.PRNGKey(0)), seed=8)
    loss, (metrics, out, target) = jax.jit(
        lambda p: jm.apply(p, *map(jnp.asarray, arrays), rng=None,
                           t=jnp.asarray(t), noise=jnp.asarray(noise)))(
        to_jax(tree))
    pm = load(DiffVits(pcfg, N_VOCAB, device="cpu"), tree)
    with torch.no_grad():
        p_loss, (p_metrics, p_out, p_target) = pm(
            *map(torch.from_numpy, arrays), t=torch.from_numpy(t),
            noise=torch.from_numpy(noise))
    assert set(p_metrics) == set(metrics)
    for k in sorted(metrics):
        assert_close(p_metrics[k], metrics[k], ATOL, rtol=1e-5)
    assert_close(p_loss, loss, ATOL, rtol=1e-5)
    assert_close(p_out, out, ATOL)
    assert_close(p_target, target, 0.0)
