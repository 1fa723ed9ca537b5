"""K5's plain version (``ops.rel_attention.fused_rel_self_attention_plain``,
the CPU route of its wrapper) and the port's routed ``MultiHeadAttention``
against the JAX package: its Pallas kernel ``fused_rel_self_attention`` in
interpret mode and the XLA formulation of its ``MultiHeadAttention``.
T in {7, 37, 130} (7 < 2w + 1: the short-sequence band) with ragged
lengths, kept rows compared (masked rows are undefined downstream), and
the unmasked case. float32, atol 2e-5 / rtol 2e-4 (the gate of
tests/test_rel_attention.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import layers as jlayers
from diff_vits_tpu.ops.rel_attention import (
    fused_rel_self_attention as jax_fused)
from diff_vits_tpu_torch import ops
from diff_vits_tpu_torch.nn.layers import MultiHeadAttention
from diff_vits_tpu_torch.ops import rel_attention as RA
from test_torch_common import fill, flax_shapes, load, to_jax

torch.set_num_threads(2)

C, HEADS, WINDOW = 64, 2, 4


def _data(t, masked, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, C)).astype(np.float32)
    lengths = np.array([t, max(t - 9, 1)], np.int32) if masked else None
    return x, lengths


def _jax_mask(t, lengths):
    keep = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return keep[:, :, None] * keep[:, None, :]           # [B, T, T]


@pytest.mark.parametrize("t,masked", [(7, True), (37, True), (130, True),
                                      (25, False)])
def test_plain_and_module_match_pallas_and_xla(t, masked):
    x, lengths = _data(t, masked, seed=t)
    jm = jlayers.MultiHeadAttention(C, C, HEADS, window_size=WINDOW,
                                    use_fused=False)
    mask4 = (None if lengths is None
             else jnp.asarray(_jax_mask(t, lengths))[:, None])
    tree = fill(flax_shapes(jm, jnp.asarray(x), jnp.asarray(x), mask4),
                seed=t + 1)
    xla = jm.apply(to_jax(tree), jnp.asarray(x), jnp.asarray(x), mask4)
    p = tree
    pallas = jax_fused(
        jnp.asarray(x), None if lengths is None
        else jnp.asarray(_jax_mask(t, lengths)),
        *[jnp.asarray(p[n][k]) for n in ("conv_q", "conv_k", "conv_v")
          for k in ("kernel", "bias")],
        jnp.asarray(p["conv_o"]["kernel"]), jnp.asarray(p["conv_o"]["bias"]),
        jnp.asarray(p["emb_rel_k"]), jnp.asarray(p["emb_rel_v"]),
        heads=HEADS, window=WINDOW, compute_dtype=jnp.float32,
        interpret=True)

    tx = torch.from_numpy(x)
    tl = None if lengths is None else torch.from_numpy(lengths)
    module = load(MultiHeadAttention(C, C, HEADS, window_size=WINDOW), tree)
    w = {n: getattr(module, n) for n in ("conv_q", "conv_k", "conv_v",
                                         "conv_o")}
    before = ops.launch_counts()
    with torch.no_grad():
        plain = RA.fused_rel_self_attention_plain(
            tx, tl, *[a for n in ("conv_q", "conv_k", "conv_v")
                      for a in (w[n].weight.t(), w[n].bias)],
            w["conv_o"].weight.t(), w["conv_o"].bias, module.emb_rel_k,
            module.emb_rel_v, heads=HEADS, window=WINDOW)
        routed = RA.fused_rel_self_attention(
            tx, tl, *[a for n in ("conv_q", "conv_k", "conv_v")
                      for a in (w[n].weight.t(), w[n].bias)],
            w["conv_o"].weight.t(), w["conv_o"].bias, module.emb_rel_k,
            module.emb_rel_v, heads=HEADS, window=WINDOW,
            compute_dtype=torch.float32)
        mod_out = module(tx, tl)
    assert ops.launch_counts() == before          # the CPU runs no kernel
    keep = (np.ones((2, t), bool) if lengths is None
            else np.arange(t)[None] < lengths[:, None])
    for port in (plain, routed, mod_out):
        assert port.shape == (2, t, C)
        for ref in (xla, pallas):
            err = np.abs(port.numpy()[keep] - np.asarray(ref)[keep]).max()
            print(f"T={t} max |port - jax| = {err:.2e}")
            np.testing.assert_allclose(port.numpy()[keep],
                                       np.asarray(ref)[keep],
                                       atol=2e-5, rtol=2e-4)


def test_module_training_route_keeps_autograd():
    """train() mode (and a recorded forward) takes the plain route: its
    gradient reaches every parameter."""
    torch.manual_seed(0)
    module = MultiHeadAttention(C, C, HEADS, window_size=WINDOW,
                                p_dropout=0.1).train()
    x = torch.randn(2, 11, C)
    out = module(x, torch.tensor([11, 6]),
                 generator=torch.Generator().manual_seed(1))
    out.square().sum().backward()
    for name, prm in module.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name
