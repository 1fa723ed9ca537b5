"""Port's denoiser training call (``DiffusionEncoder.forward``: prompt
encoder + UNet embedding its own timesteps) against the JAX package at
the tiny widths of ``test_torch_common`` in eval mode: the x0 prediction
within atol 1e-4, then the gradient of sum((x0 - target)^2) against
``jax.grad``, every leaf within rtol 1e-3 (``assert_grads_close``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.diffusion_encoder import DiffusionEncoder as JDE
from diff_vits_tpu_torch.models.diffusion_encoder import DiffusionEncoder
from test_torch_common import (
    assert_close, assert_grads_close, fill, flax_shapes, load, tiny_configs,
    to_jax)
from test_torch_train import batch

torch.set_num_threads(2)


def test_denoiser_forward_and_gradients_match_jax():
    jcfg, pcfg = tiny_configs()
    (_, _, spec, spec_lengths, refer, refer_lengths, _, _), t, noise = batch()
    rng = np.random.default_rng(11)
    cond = rng.normal(size=spec.shape[:2] + (16,)).astype(np.float32)
    arrays = (noise, t, cond, refer, spec_lengths, refer_lengths)
    jm = JDE(jcfg.diffusion_encoder)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=12)

    def loss_fn(params):
        out = jm.apply({"params": params}, *map(jnp.asarray, arrays))
        return jnp.sum((out - jnp.asarray(spec)) ** 2), out
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(tree)["params"])

    pm = load(DiffusionEncoder(pcfg.diffusion_encoder, device="cpu"), tree)
    out = pm(*map(torch.from_numpy, arrays))
    assert_close(out, ref, 1e-4)
    ((out - torch.from_numpy(spec)) ** 2).sum().backward()
    assert_grads_close(pm, grads)
