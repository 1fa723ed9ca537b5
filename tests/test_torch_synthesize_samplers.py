"""``synthesize`` of the port with DPM-Solver++ (``sample_method=
"dpmsolver"``: multistep, order 2, the hoisted per-step embeddings)
against the JAX package's on the tiny config: a ragged batch of 2, 30
steps, injected initial noise, zero prior noise, float32. Gate: max |mel
diff| <= 5e-3 (tests/test_e2e_sample_parity.py's); frame counts equal.
DDIM is in tests/test_torch_synthesize_ddim.py (each file compiles the
JAX sampler once), the sampler loops alone in tests/test_torch_sampler.py;
an unknown name raises ValueError as in JAX."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu_torch.models.diff_vits import synthesize
from test_torch_synthesize import GATE, ORDER, make_batch, tiny_models

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=11)


def check_sampler_matches_jax(models, method, steps=30, b=2, max_len=40):
    """One ragged batch through both packages' ``synthesize``; returns the
    port's mel and the number of UNet calls it made."""
    jm, params, pm = models
    data = make_batch(b, 8, 11, seed=20 + b)
    noise = np.random.default_rng(30 + b).normal(
        size=(b, max_len, 100)).astype(np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=steps, sample_method=method,
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(params, *[jnp.asarray(data[k]) for k in ORDER],
                           key=jax.random.PRNGKey(0),
                           init_noise=jnp.asarray(noise))
    calls = []
    hook = pm.diff_model.unet.register_forward_pre_hook(
        lambda m, args, kw: calls.append(kw.get("embedding_request")),
        with_kwargs=True)
    try:
        mel, out_len = synthesize(
            pm, *[torch.from_numpy(data[k]) for k in ORDER],
            sampling_steps=steps, sample_method=method, noise_scale=0.0,
            max_len=max_len, init_noise=torch.from_numpy(noise),
            device="cpu")
    finally:
        hook.remove()
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert mel.shape == (b, max_len, 100) and mel.dtype == torch.float32
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"{method}: max |mel diff| = {err:.2e} (gate {GATE})")
    assert err <= GATE, err
    return mel, calls


def test_dpmsolver_matches_jax(models):
    _, calls = check_sampler_matches_jax(models, "dpmsolver")
    # one denoiser call a step, on the hoisted embeddings (plus the one
    # time and one text embedding request made before the loop)
    assert calls.count(None) == 30
    assert sorted(c for c in calls if c) == ["text", "time"]


def test_unknown_sampler_raises_value_error(models):
    _, _, pm = models
    data = make_batch(1, 8, 11, seed=0)
    with pytest.raises(ValueError, match="unknown sample_method"):
        synthesize(pm, *[torch.from_numpy(data[k]) for k in ORDER],
                   sample_method="euler", device="cpu")
