"""The mixture-of-experts feed-forward of the port
(``diff_vits_tpu_torch/parallel/moe.py``) against the JAX package on the
CPU, float32:

* ``MoEFeedForward`` against JAX's module (atol 1e-5) and against a
  per-token oracle in numpy (each token: the top-k gate logits, their
  softmax, the weighted sum of the selected experts' GEGLU outputs);
* ``BasicTransformerBlock(moe_experts=4)`` against JAX's (the block's
  plain route: an MoE block never takes the fused kernels K2-K4);
* the denoiser (``DiffusionEncoder`` with ``moe_experts=4``): its x0
  prediction (atol 1e-4) and the gradient of a loss on it against
  ``jax.grad`` (``assert_grads_close``: every leaf within rtol 1e-3);
* the ``ff_moe`` leaves and the gate both ways: ``to_flax_params`` gives
  JAX's tree (names, shapes, layouts, the stacked experts untransposed),
  and a model written by ``utils.msgpack_ckpt.pack`` and read back loads
  with equal values.

``synthesize`` with the MoE UNet is in ``test_torch_moe_synthesize.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from diff_vits_tpu.models.diffusion_encoder import DiffusionEncoder as JDE
from diff_vits_tpu.nn.unet1d import BasicTransformerBlock as JBlock
from diff_vits_tpu.parallel.moe import MoEFeedForward as JMoE
from diff_vits_tpu_torch.models.diffusion_encoder import DiffusionEncoder
from diff_vits_tpu_torch.nn.unet1d import BasicTransformerBlock
from diff_vits_tpu_torch.parallel.moe import MoEFeedForward
from diff_vits_tpu_torch.utils import msgpack_ckpt
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_common import (
    assert_close, assert_grads_close, fill, flax_shapes, load, tiny_configs,
    to_jax)
from test_torch_train import batch

torch.set_num_threads(2)

E, K = 4, 2


def fill_moe(shapes, seed):
    """``fill`` with the stacked expert kernels scaled like trained weights
    (``fill`` treats any leaf not named ``kernel`` as a bias)."""
    tree = flatten_dict(fill(shapes, seed))
    rng = np.random.default_rng(seed + 1000)
    for path, v in tree.items():
        if path[-1] in ("w1", "w2"):
            tree[path] = (rng.normal(size=v.shape) / np.sqrt(v.shape[1])
                          ).astype(np.float32)
    return unflatten_dict(tree)


def oracle(x, tree, top_k):
    """MoEFeedForward token by token in float64 numpy."""
    w_gate = tree["gate"]["kernel"]
    w1, b1, w2, b2 = (np.asarray(tree[k], np.float64)
                      for k in ("w1", "b1", "w2", "b2"))
    erf = np.vectorize(__import__("math").erf)
    out = np.zeros(x.shape)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            tok = x[b, t].astype(np.float64)
            logits = tok @ w_gate
            top = np.argsort(-logits)[:top_k]
            w = np.exp(logits[top] - logits[top].max())
            w /= w.sum()
            for e, we in zip(top, w):
                u = tok @ w1[e] + b1[e]
                a, g = np.split(u, 2)
                h = a * 0.5 * g * (1 + erf(g / np.sqrt(2)))
                out[b, t] += we * (h @ w2[e] + b2[e])
    return out


def test_moe_feed_forward_matches_jax_and_the_oracle():
    x = np.random.default_rng(0).normal(size=(2, 7, 16)).astype(np.float32)
    jm = JMoE(16, E, top_k=K)
    tree = fill_moe(flax_shapes(jm, jnp.asarray(x)), seed=3)
    ref = np.asarray(jm.apply(to_jax(tree), jnp.asarray(x)))
    pm = load(MoEFeedForward(16, E, K), tree)
    with torch.no_grad():
        out = pm(torch.from_numpy(x)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, oracle(x, tree, K), atol=1e-5, rtol=1e-5)


def test_moe_transformer_block_matches_jax_on_the_plain_route():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 8)).astype(np.float32)
    bias = np.where(np.arange(5)[None, None] < np.array([[[5]], [[3]]]),
                    0.0, -1e4).astype(np.float32)
    jm = JBlock(16, 2, 8, cross_attention_dim=8, moe_experts=E,
                moe_top_k=K)
    args = (jnp.asarray(x), jnp.asarray(ctx), None, jnp.asarray(bias))
    tree = fill_moe(flax_shapes(jm, *args), seed=4)
    assert "ff_moe" in tree and "ff" not in tree
    ref = jm.apply(to_jax(tree), *args)
    pm = load(BasicTransformerBlock(16, 2, 8, cross_attention_dim=8,
                                    moe_experts=E, moe_top_k=K), tree)
    assert not pm._fused_enabled(None)     # eval mode, no bias: still plain
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(ctx), None,
                 torch.from_numpy(bias))
    assert_close(out, ref, 1e-5)


def _moe_configs():
    jcfg, pcfg = tiny_configs()
    return (dataclasses.replace(jcfg.diffusion_encoder, moe_experts=E,
                                moe_top_k=K),
            dataclasses.replace(pcfg.diffusion_encoder, moe_experts=E,
                                moe_top_k=K))


def test_moe_denoiser_forward_and_gradients_match_jax():
    jdc, pdc = _moe_configs()
    (_, _, spec, spec_lengths, refer, refer_lengths, _, _), t, noise = batch()
    cond = np.random.default_rng(11).normal(
        size=spec.shape[:2] + (16,)).astype(np.float32)
    arrays = (noise, t, cond, refer, spec_lengths, refer_lengths)
    jm = JDE(jdc)
    tree = fill_moe(flax_shapes(jm, *map(jnp.asarray, arrays)), seed=12)
    assert any("ff_moe" in p for p in flatten_dict(tree, sep="/"))

    def loss_fn(params):
        out = jm.apply({"params": params}, *map(jnp.asarray, arrays))
        return jnp.sum((out - jnp.asarray(spec)) ** 2), out
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        to_jax(tree)["params"])

    pm = load(DiffusionEncoder(pdc, device="cpu"), tree)
    out = pm(*map(torch.from_numpy, arrays))
    assert_close(out, ref, 1e-4)
    ((out - torch.from_numpy(spec)) ** 2).sum().backward()
    assert_grads_close(pm, grads)
    assert all(pm.get_parameter(n).grad.abs().max() > 0
               for n, _ in pm.named_parameters() if ".ff_moe." in n)


def test_moe_leaves_round_trip_through_flax_and_msgpack(tmp_path):
    _, pdc = _moe_configs()
    pm = DiffusionEncoder(pdc, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tree = to_flax_params(pm)
    moe = tree["unet"]["mid"]["attn_0"]["block_0"]["ff_moe"]
    d = pdc.block_out_channels[-1]
    assert {k: v.shape for k, v in moe.items() if k != "gate"} == {
        "w1": (E, d, 8 * d), "b1": (E, 8 * d), "w2": (E, 4 * d, d),
        "b2": (E, d)}
    block = pm.unet.mid.attn_0.block_0.ff_moe
    np.testing.assert_array_equal(moe["w1"], block.w1.detach().numpy())
    np.testing.assert_array_equal(moe["gate"]["kernel"],
                                  block.gate.weight.detach().numpy().T)
    path = tmp_path / "moe.msgpack"
    path.write_bytes(msgpack_ckpt.pack({"params": tree}))
    back = msgpack_ckpt.unpack(path.read_bytes())
    sd = convert_tree(back)
    fresh = DiffusionEncoder(pdc, device="cpu")
    fresh.load_state_dict(sd, strict=True)
    for (n, a), b in zip(pm.state_dict().items(),
                         fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
