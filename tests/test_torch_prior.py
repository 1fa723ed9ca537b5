"""Port's prior-side modules against the JAX package: TextEncoder,
PromptEncoder and DurationPredictorUNet on ragged batches, including a
text of 3 tokens (shorter than the relative-attention window). float32,
same flax parameter tree and numpy inputs in both, atol 1e-4; the JAX side
runs jitted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models.duration import DurationPredictorUNet as JDP
from diff_vits_tpu.models.encoders import (
    PromptEncoder as JPrompt, TextEncoder as JText)
from diff_vits_tpu_torch.models.duration import DurationPredictorUNet
from diff_vits_tpu_torch.models.encoders import PromptEncoder, TextEncoder
from test_torch_common import (
    TINY_VITS, assert_close, fill, flax_shapes, load, to_jax)

torch.set_num_threads(2)

ATOL = 1e-4
V = TINY_VITS
N_VOCAB = 40


def _text(b, t, lengths, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, N_VOCAB, (b, t)).astype(np.int32)
    tone = rng.integers(0, 11, (b, t)).astype(np.int32)
    lang = rng.integers(0, 3, (b, t)).astype(np.int32)
    g = rng.normal(size=(b, 1, V["gin_channels"])).astype(np.float32)
    return text, np.asarray(lengths, np.int32), tone, lang, g


def _run(jm, pm_ctor, arrays, seed, **jkw):
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays), **jkw),
                seed=seed)
    pm = load(pm_ctor(), tree)
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, **jkw))(
        to_jax(tree), *map(jnp.asarray, arrays))
    with torch.no_grad():
        port = pm(*map(torch.from_numpy, arrays),
                  **{k: torch.from_numpy(np.asarray(v)) for k, v in
                     jkw.items()})
    return port, ref


@pytest.mark.parametrize("b,t,lengths", [(3, 9, [9, 5, 1]), (2, 3, [3, 2])])
def test_text_encoder_matches_jax(b, t, lengths):
    text, tl, tone, lang, g = _text(b, t, lengths, seed=t)
    jm = JText(N_VOCAB, V["inter_channels"], V["hidden_channels"],
               V["filter_channels"], V["n_heads"], V["n_layers"],
               V["kernel_size"], 0.0, gin_channels=V["gin_channels"])

    def ctor():
        return TextEncoder(N_VOCAB, V["inter_channels"], V["hidden_channels"],
                           V["filter_channels"], V["n_heads"], V["n_layers"],
                           V["kernel_size"], gin_channels=V["gin_channels"],
                           device="cpu")
    port, ref = _run(jm, ctor, (text, tl, tone, lang), seed=1, g=g)
    for p_, r_ in zip(port, ref):
        assert_close(p_, r_, ATOL)


def test_prompt_encoder_matches_jax():
    rng = np.random.default_rng(4)
    b, t = 3, 14
    x = rng.normal(size=(b, t, 16)).astype(np.float32)
    lengths = np.array([14, 6, 1], np.int32)
    g = rng.normal(size=(b, 1, 8)).astype(np.float32)
    jm = JPrompt(16, 32, 16, 2, 0.2, gin_channels=8)
    port, ref = _run(jm, lambda: PromptEncoder(16, 32, 16, 2, gin_channels=8,
                                               device="cpu"),
                     (x, lengths), seed=2, g=g)
    assert_close(port, ref, ATOL)


@pytest.mark.parametrize("t,lengths", [(11, [11, 4]), (4, [4, 2])])
def test_duration_predictor_unet_matches_jax(t, lengths):
    rng = np.random.default_rng(t)
    b, s = 2, 13
    x = rng.normal(size=(b, t, 32)).astype(np.float32)
    prompt = rng.normal(size=(b, s, 100)).astype(np.float32)
    arrays = (x, np.asarray(lengths, np.int32), prompt,
              np.array([13, 7], np.int32))
    jm = JDP(32, 256, 100)
    port, ref = _run(jm, lambda: DurationPredictorUNet(32, 256, 100,
                                                       device="cpu"),
                     arrays, seed=3)
    assert port.shape == (b, t, 1)
    assert_close(port, ref, ATOL)
