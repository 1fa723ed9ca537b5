"""bv2's training gradients in the port against ``jax.grad`` at float32:
``VITS.forward`` with ``use_phoneme_vae`` (model3's unet duration
predictor), JAX's deterministic mode (no noise key), the loss l_length +
loss_kl + loss_kl_ph + sum(content * r); every parameter leaf within the
tolerance of test_torch_train_vits.py (``assert_grads_close``: rtol 1e-3
plus 1e-3 of the leaf's largest |gradient|), the VAE's leaves included.
Weights: the JAX training forward's tree at tiny widths (2 flows),
filled from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.models.vits import VITS
from test_torch_common import (
    assert_grads_close, fill, flax_shapes, load, tiny_configs, to_jax)
from test_torch_train import N_VOCAB, batch

torch.set_num_threads(2)


def _configs(**change):
    return tuple(dataclasses.replace(c.vits, use_phoneme_vae=True,
                                     n_flow_layer=2, **change)
                 for c in tiny_configs())


def test_vits_gradients_with_the_phoneme_vae_match_jax_grad():
    jcfg, pcfg = _configs()
    arrays, _, _ = batch()
    arrays = arrays[:4] + arrays[6:]
    jm = JVITS(N_VOCAB, jcfg)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=41)
    pm = load(VITS(N_VOCAB, pcfg, device="cpu"), tree)
    r = np.random.default_rng(12).normal(size=(3, 30, 16)).astype(np.float32)

    def loss_fn(params):
        content, _, (l_length, loss_kl, loss_kl_ph) = jm.apply(
            {"params": params}, *map(jnp.asarray, arrays))
        return (l_length + loss_kl + loss_kl_ph
                + jnp.sum(content * jnp.asarray(r)))
    grads = jax.jit(jax.grad(loss_fn))(to_jax(tree)["params"])
    content, _, (l_length, loss_kl, loss_kl_ph) = pm(
        *map(torch.from_numpy, arrays))
    (l_length + loss_kl + loss_kl_ph
     + (content * torch.from_numpy(r)).sum()).backward()
    assert pm.phoneme_vae.ph_enc_p.layer_3.in_proj.weight.grad.abs().max() > 0
    assert_grads_close(pm, grads)
