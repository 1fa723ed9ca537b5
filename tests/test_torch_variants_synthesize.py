"""End-to-end ``synthesize`` of the port against the JAX package for the
variant (stochastic duration predictor, residual-coupling spec flow) on a
ragged batch of 3: VITS prior with its duration draw injected (JAX's
``normal(fold_in(k_prior, 3), (B, Tx, 2))``, k_prior the first half of
``split(key)``), zero prior noise, injected initial noise, 30-step UniPC
over the UNet. Gate: max |mel diff| <= 5e-3 (tests/test_e2e_sample_parity.py)
and equal frame counts."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import fill, flax_shapes, tiny_configs, to_jax
from test_torch_synthesize import GATE, ORDER, make_batch

torch.set_num_threads(2)

VARIANT = dict(duration_predictor="sdp", use_flow=True, n_flow_layer=2)


def test_synthesize_sdp_residual_flow_matches_jax_ragged_b3():
    jcfg, pcfg = tiny_configs()
    jcfg = dataclasses.replace(jcfg, vits=dataclasses.replace(jcfg.vits,
                                                              **VARIANT))
    pcfg = dataclasses.replace(pcfg, vits=dataclasses.replace(pcfg.vits,
                                                              **VARIANT))
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, tx, s, max_len = 3, 8, 11, 40
    data = make_batch(b, tx, s, seed=3)
    # the training forward's tree: every leaf (the SDP's post_* included)
    shapes = flax_shapes(
        jm, jnp.asarray(data["text"]), jnp.asarray(data["text_lengths"]),
        jnp.zeros((b, 20, 100)), jnp.array([20, 15, 8]),
        jnp.asarray(data["refer"]), jnp.asarray(data["refer_lengths"]),
        jnp.asarray(data["tone"]), jnp.asarray(data["language"]),
        rng=jax.random.PRNGKey(2))
    tree = fill(shapes, seed=1)
    pm = DiffVits(pcfg, len(symbols), device="cpu")
    pm.load_state_dict(from_flax_params(tree, pcfg), strict=True)

    key = jax.random.PRNGKey(0)
    k_prior, _ = jax.random.split(key)
    dur_noise = np.array(jax.random.normal(jax.random.fold_in(k_prior, 3),
                                           (b, tx, 2)))
    noise = np.random.default_rng(103).normal(
        size=(b, max_len, 100)).astype(np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=30, sample_method="unipc",
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(to_jax(tree),
                           *[jnp.asarray(data[k]) for k in ORDER], key=key,
                           init_noise=jnp.asarray(noise))
    mel, out_len = synthesize(
        pm.eval(), *[torch.from_numpy(data[k]) for k in ORDER],
        sampling_steps=30, noise_scale=0.0, max_len=max_len,
        init_noise=torch.from_numpy(noise),
        dur_noise=torch.from_numpy(dur_noise), device="cpu")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    assert (out_len.numpy() > 1).all() and (out_len.numpy() < max_len).any()
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"max |mel diff| = {err:.2e} (gate {GATE}); frames "
          f"{out_len.tolist()}")
    assert err <= GATE, err
