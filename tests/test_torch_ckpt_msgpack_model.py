"""A model trained with the JAX package, served by the port: the tiny
model's trainer state written by JAX's ``train/checkpoint.save_checkpoint``
(one bfloat16 leaf, an optax AdamW state) is read by the port's
``load_model_state_dict`` (no flax), and the ``DiffVits`` it gives
synthesizes (30-step UniPC, injected initial noise, zero prior noise)
within 5e-3 of JAX's ``synthesize`` with the parameters flax restores
from the same file (the gate of tests/test_e2e_sample_parity.py); frame
counts equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint
from test_torch_ckpt_msgpack import _trainer_state
from test_torch_common import tiny_configs
from test_torch_synthesize import ORDER, make_batch, tiny_models

torch.set_num_threads(2)

GATE = 5e-3


def test_model_from_a_jax_checkpoint_synthesizes_as_jax(tmp_path):
    jm, jparams, _ = tiny_models(seed=5)
    path = jckpt.save_checkpoint(str(tmp_path), 1234,
                                 _trainer_state(jparams["params"]), keep=0)
    jcfg, pcfg = tiny_configs()
    model = DiffVits(pcfg, len(symbols), device="cpu")
    model.load_state_dict(checkpoint.load_model_state_dict(path, pcfg),
                          strict=True)
    saved = serialization.msgpack_restore(open(path, "rb").read())["state"]
    params = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), saved["params"])}
    b, max_len = 2, 40
    data = make_batch(b, 8, 11, seed=9)
    noise = np.random.default_rng(9).normal(size=(b, max_len, 100)).astype(
        np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=30, sample_method="unipc",
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(params, *[jnp.asarray(data[k]) for k in ORDER],
                           key=jax.random.PRNGKey(0),
                           init_noise=jnp.asarray(noise))
    mel, out_len = synthesize(
        model, *[torch.from_numpy(data[k]) for k in ORDER], sampling_steps=30,
        noise_scale=0.0, max_len=max_len, init_noise=torch.from_numpy(noise),
        device="cpu")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"max |mel diff| = {err:.2e} (gate {GATE})")
    assert err <= GATE
