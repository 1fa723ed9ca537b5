"""The VITS variants' training forward in the port against the JAX
package: ``VITS.forward`` for the stochastic (``sdp``) and the conv
duration predictor, each without a spec flow, with the residual-coupling
flow and with the transformer-coupling flow, against JAX ``VITS.__call__``
in its deterministic mode (eval, no noise key: zero posterior and MAS
noise, the stochastic predictor's posterior draw from PRNGKey(0)). The
test computes that draw, ``normal(split(PRNGKey(0), 1)[0], (B, Tx, 2))``,
with JAX and injects it as ``dur_noise``. float32; content within atol
1e-4, l_length and loss_kl within rel 1e-5 (atol 1e-4 + rtol 1e-5), equal
lengths. Two variants, which between them run every branch, are also held
to ``jax.grad`` of l_length + loss_kl + sum(content * r): every parameter
leaf within the tolerance of test_torch_train_vits.py
(``assert_grads_close``: rtol 1e-3 plus an atol of 1e-3 times the leaf's
largest |gradient|).

A jitted JAX forward with the stochastic predictor's flows compiles for
~15 s on a CPU and its gradient for ~40 s, so the cases are spread over
three files, each under a minute serially: here sdp without a flow and
with the transformer flow; test_torch_train_variants_conv.py the conv
predictor (the transformer flow with gradients) and the ``Trainer`` on a
variant; test_torch_train_variants_grad.py sdp with the residual flow,
with gradients.

Weights: the JAX training forward's parameter tree, filled from a numpy
seed and carried across by ``convert_tree`` (the tiny widths of
test_torch_variants: 2 flows, 2 transformer-flow layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.models.vits import VITS
from test_torch_common import (
    assert_close, assert_grads_close, fill, flax_shapes, load, to_jax)
from test_torch_train import N_VOCAB, batch
from test_torch_variants import variant_configs

torch.set_num_threads(2)

VARIANTS = {
    f"{dp}_{flow}": dict(duration_predictor=dp, use_flow=flow != "none",
                         use_transformer_flow=flow == "transformer")
    for dp in ("sdp", "conv") for flow in ("none", "residual", "transformer")}


def jax_dur_noise(arrays):
    """The stochastic predictor's posterior draw e_q of JAX's
    deterministic mode (vits.py:129-133, duration.py:139-141)."""
    b, tx = arrays[0].shape
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    return np.array(jax.random.normal(key, (b, tx, 2)))


def variant_case(name, seed):
    """(JAX module, parameter tree, port module, batch arrays) of the
    variant ``name``."""
    jcfg, pcfg = variant_configs(**VARIANTS[name])
    arrays, _, _ = batch()
    arrays = arrays[:4] + arrays[6:]              # no prompt: the prior only
    jm = JVITS(N_VOCAB, jcfg)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=seed)
    pm = load(VITS(N_VOCAB, pcfg, device="cpu"), tree)
    return jm, tree, pm, arrays


def _port_forward(pm, arrays):
    return pm(*map(torch.from_numpy, arrays),
              dur_noise=torch.from_numpy(jax_dur_noise(arrays)))


def _check_outputs(port, ref):
    (content, lengths, (l_length, loss_kl, loss_kl_ph)), \
        (ref_c, ref_len, ref_dur, ref_kl) = port, ref
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    assert content.shape == (3, 30, 16) and float(loss_kl_ph) == 0.0
    assert_close(content, ref_c, 1e-4)
    assert_close(l_length, ref_dur, 1e-4, rtol=1e-5)
    assert_close(loss_kl, ref_kl, 1e-4, rtol=1e-5)


def check_training_forward(name):
    jm, tree, pm, arrays = variant_case(name, seed=21)
    ref_c, ref_len, (ref_dur, ref_kl, _) = jax.jit(jm.apply)(
        to_jax(tree), *map(jnp.asarray, arrays))
    with torch.no_grad():
        port = _port_forward(pm, arrays)
    _check_outputs(port, (ref_c, ref_len, ref_dur, ref_kl))


def check_forward_and_gradients(name):
    jm, tree, pm, arrays = variant_case(name, seed=23)
    r = np.random.default_rng(10).normal(size=(3, 30, 16)).astype(np.float32)

    def loss_fn(params):
        content, lengths, (l_length, loss_kl, _) = jm.apply(
            {"params": params}, *map(jnp.asarray, arrays))
        loss = l_length + loss_kl + jnp.sum(content * jnp.asarray(r))
        return loss, (content, lengths, l_length, loss_kl)
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(tree)["params"])
    port = _port_forward(pm, arrays)
    _check_outputs(port, ref)
    content, _, (l_length, loss_kl, _) = port
    (l_length + loss_kl + (content * torch.from_numpy(r)).sum()).backward()
    assert_grads_close(pm, grads)


@pytest.mark.parametrize("name", ["sdp_none", "sdp_transformer"])
def test_vits_training_forward_matches_jax(name):
    check_training_forward(name)
