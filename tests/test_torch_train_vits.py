"""Port's ``VITS.forward`` (the training forward of the prior: posterior,
MAS, duration and KL losses, content) against the JAX package at the tiny
widths of ``test_torch_common``, in the deterministic mode (eval, zero
posterior and MAS noise): content within atol 1e-4, l_length and loss_kl
within atol 1e-4 + rtol 1e-5, equal lengths. Then the gradient of
l_length + loss_kl + sum(content * r) against ``jax.grad``, every leaf
within rtol 1e-3 (``assert_grads_close``). The JAX side is one jitted
value_and_grad."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.models.vits import VITS
from test_torch_common import (
    assert_close, assert_grads_close, fill, flax_shapes, load, tiny_configs,
    to_jax)
from test_torch_train import N_VOCAB, batch

torch.set_num_threads(2)


def test_vits_training_forward_and_gradients_match_jax():
    jcfg, pcfg = tiny_configs()
    (text, tl, spec, sl, _, _, tone, lang), _, _ = batch()
    arrays = (text, tl, spec, sl, tone, lang)
    jm = JVITS(N_VOCAB, jcfg.vits)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=7)
    r = np.random.default_rng(10).normal(size=(3, 30, 16)).astype(np.float32)

    def loss_fn(params):
        content, lengths, (l_length, loss_kl, _) = jm.apply(
            {"params": params}, *map(jnp.asarray, arrays))
        loss = l_length + loss_kl + jnp.sum(content * jnp.asarray(r))
        return loss, (content, lengths, l_length, loss_kl)
    (_, (ref_c, ref_len, ref_dur, ref_kl)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree)["params"])

    pm = load(VITS(N_VOCAB, pcfg.vits, device="cpu"), tree)
    content, lengths, (l_length, loss_kl, loss_kl_ph) = pm(
        *map(torch.from_numpy, arrays))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert content.shape == (3, 30, 16) and float(loss_kl_ph) == 0.0
    assert_close(content, ref_c, 1e-4)
    assert_close(l_length, ref_dur, 1e-4, rtol=1e-5)
    assert_close(loss_kl, ref_kl, 1e-4, rtol=1e-5)
    (l_length + loss_kl + (content * torch.from_numpy(r)).sum()).backward()
    assert_grads_close(pm, grads)
