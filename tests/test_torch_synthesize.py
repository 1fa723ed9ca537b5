"""End-to-end ``synthesize`` of the port against the JAX package on the
tiny config: text + prompt mel -> VITS prior -> 30-step UniPC (bh2, order
2) over the UNet -> mel, with injected initial noise and zero prior noise
(random streams cannot match across frameworks). Gate: max |mel diff| <=
5e-3, the gate of tests/test_e2e_sample_parity.py. Frame counts must be
equal. The ragged batch of 3 is in test_torch_synthesize_batch.py (each
file compiles the JAX sampler once, ~30 s on a CPU)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import fill, flax_shapes, tiny_configs, to_jax

torch.set_num_threads(2)

GATE = 5e-3


def tiny_models(seed: int = 0):
    """(JAX DiffVits, its params, port DiffVits) with the same weights,
    carried over by from_flax_params."""
    jcfg, pcfg = tiny_configs()
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, t, s, ty = 1, 5, 7, 12
    text = jnp.ones((b, t), jnp.int32)
    lengths = jnp.full((b,), t, jnp.int32)
    refer = jnp.zeros((b, s, 100))
    refer_lengths = jnp.full((b,), s, jnp.int32)

    def init_path(m):
        # the posterior encoder's weights too (speaker-conditioned)
        m.vits.enc_q(refer, refer_lengths,
                     g=m.vits.ref_enc(refer)[:, None, :])
        content, _ = m.vits_infer(text, lengths, refer, refer_lengths, text,
                                  text, noise_key=jax.random.PRNGKey(0),
                                  max_len=ty)
        ph, pk = m.encode_prompt(refer, refer_lengths)
        return m.denoise_cached(jnp.zeros((b, ty, 100)), jnp.ones((b,)),
                                content, ph, pk)

    tree = fill(flax_shapes(jm, method=init_path), seed=seed)
    pm = DiffVits(pcfg, len(symbols), device="cpu")
    pm.load_state_dict(from_flax_params(tree, pcfg), strict=True)
    return jm, to_jax(tree), pm.eval()


def make_batch(b, t, s, seed):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 3, 2][:b], np.int32)
    return dict(
        text=rng.integers(1, len(symbols), (b, t)).astype(np.int32),
        text_lengths=lengths,
        refer=rng.normal(size=(b, s, 100)).astype(np.float32),
        refer_lengths=np.array([s, s - 4, s][:b], np.int32),
        tone=rng.integers(0, 11, (b, t)).astype(np.int32),
        language=rng.integers(0, 3, (b, t)).astype(np.int32))


ORDER = ("text", "text_lengths", "refer", "refer_lengths", "tone",
         "language")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def check_synthesize_matches_jax(models, b):
    """One batch of ``b`` (ragged for b > 1) through both packages."""
    jm, params, pm = models
    max_len = 40
    data = make_batch(b, 8, 11, seed=b)
    noise = np.random.default_rng(100 + b).normal(
        size=(b, max_len, 100)).astype(np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=30, sample_method="unipc",
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(params, *[jnp.asarray(data[k]) for k in ORDER],
                           key=jax.random.PRNGKey(0),
                           init_noise=jnp.asarray(noise))
    mel, out_len = synthesize(
        pm, *[torch.from_numpy(data[k]) for k in ORDER], sampling_steps=30,
        noise_scale=0.0, max_len=max_len, init_noise=torch.from_numpy(noise),
        device="cpu")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert mel.shape == (b, max_len, 100) and mel.dtype == torch.float32
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"b={b}: max |mel diff| = {err:.2e} (gate {GATE})")
    assert err <= GATE, err
    return err


def test_synthesize_matches_jax_b1(models):
    check_synthesize_matches_jax(models, 1)
