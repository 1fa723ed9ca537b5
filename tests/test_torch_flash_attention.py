"""K8's plain version and the flash-attention routes of the port against
the JAX package (``diff_vits_tpu/ops/flash_attention.py``, whose ``sdpa``
takes its XLA formulation ``xla_sdpa`` off the TPU).

* ``sdpa`` on the CPU (``sdpa_plain``, also with ``use_flash=True``, which
  stays plain off the card) against ``xla_sdpa``: head dims 8, 16, 32, 64,
  a ragged keep mask or none; float32 within atol 1e-5; bfloat16 inputs
  within one bfloat16 rounding of ``xla_sdpa`` in float32 on the same
  rounded inputs (rtol 2^-8, atol 1e-5), and within 3e-2 of ``xla_sdpa``
  computed in bfloat16 (which rounds its scores and probabilities).
* The gradients of sum(out * r) with respect to q, k and v: autograd of
  the port and ``sdpa_backward_plain`` (the kernel's backward written out)
  against ``jax.grad`` of ``xla_sdpa``, float32, within rel 1e-5 of each
  gradient's largest entry; the row log-sum-exp against JAX's.
* ``flash_ok`` against the JAX gate's shape logic (its TPU-backend test
  answered "tpu") at the shapes of every attention site of the training
  step at ``reference_parity`` width.
* ``CrossAttention`` (self and cross, ragged key bias) and ``EncSALayer``
  with ``use_flash=True`` against the JAX modules with ``use_flash=True``,
  with the weights carried across by ``convert_tree``, atol 1e-5; the port
  took the flash route (``sdpa``), and ``set_use_flash`` switches it apart
  from ``set_use_fused``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn.fairseq import EncSALayer as JEncSALayer
from diff_vits_tpu.nn.unet1d import CrossAttention as JCrossAttention
from diff_vits_tpu.ops import flash_attention as JFA
from diff_vits_tpu_torch.nn import fairseq as tfairseq
from diff_vits_tpu_torch.nn import unet1d as tunet
from diff_vits_tpu_torch.ops import flash_attention as FA
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)

B, H, T, S = 3, 2, 37, 29


def _inputs(seed, d, ragged, t=T, s=S):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, n, d)).astype(np.float32)
               for n in (t, s, s))
    keep = None
    if ragged:
        keep = np.arange(s)[None] < np.array([[s], [s // 2], [1]])
    return q, k, v, keep


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


CASES = pytest.mark.parametrize("d,ragged", [
    (d, ragged) for d in (8, 16, 32, 64) for ragged in (True, False)])


@CASES
def test_sdpa_matches_jax_xla_sdpa(d, ragged):
    q, k, v, keep = _inputs(d, d, ragged)
    scale = d ** -0.5
    ref = JFA.xla_sdpa(*_jax(q, k, v, keep), sm_scale=scale)
    assert_close(FA.sdpa(*_torch(q, k, v, keep), sm_scale=scale), ref, 1e-5)
    out, lse = FA.sdpa_plain(*_torch(q, k, v, keep), sm_scale=scale,
                             with_lse=True)
    routed = FA.sdpa(*_torch(q, k, v, keep), sm_scale=scale, use_flash=True)
    assert torch.equal(routed, out)          # the CPU takes the plain route
    jax_routed = JFA.sdpa(*_jax(q, k, v, keep), sm_scale=scale,
                          use_flash=True)   # XLA off the TPU
    assert_close(routed, jax_routed, 1e-5)
    scores = jnp.einsum("bhtd,bhsd->bhts", *_jax(q, k)) * scale
    if keep is not None:
        scores = scores + jnp.where(jnp.asarray(keep), 0.0, -10000.0)[
            :, None, None, :]
    assert_close(lse, jax.nn.logsumexp(scores, axis=-1), 1e-5)


@CASES
def test_sdpa_bfloat16_matches_jax(d, ragged):
    q, k, v, keep = _inputs(d + 1, d, ragged)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = FA.sdpa(tq, tk, tv, *_torch(keep), sm_scale=d ** -0.5)
    assert out.dtype == torch.bfloat16
    rounded = [t.float().numpy() for t in (tq, tk, tv)]
    ref32 = JFA.xla_sdpa(*_jax(*rounded, keep), sm_scale=d ** -0.5)
    assert_close(out, ref32, 1e-5, rtol=2 ** -8)
    ref16 = JFA.xla_sdpa(*[jnp.asarray(a, jnp.bfloat16) for a in rounded],
                         None if keep is None else jnp.asarray(keep),
                         sm_scale=d ** -0.5)
    assert_close(out, ref16.astype(jnp.float32), 3e-2)


def _assert_rel(port, ref, rel):
    ref = np.asarray(ref, np.float32)
    assert_close(port, ref, rel * float(np.abs(ref).max()), rtol=rel)


@CASES
def test_sdpa_gradients_match_jax_grad(d, ragged):
    q, k, v, keep = _inputs(d + 2, d, ragged)
    r = np.random.default_rng(d).normal(size=(B, H, T, d)).astype(np.float32)
    scale = d ** -0.5
    jkeep = None if keep is None else jnp.asarray(keep)
    ref = jax.grad(lambda q, k, v: jnp.sum(JFA.xla_sdpa(
        q, k, v, jkeep, sm_scale=scale) * r), argnums=(0, 1, 2))(
        *_jax(q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tkeep, = _torch(keep)
    out, lse = FA.sdpa_plain(tq, tk, tv, tkeep, sm_scale=scale,
                             with_lse=True)
    (out * torch.from_numpy(r)).sum().backward()
    manual = FA.sdpa_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse.detach(),
        torch.from_numpy(r), tkeep, sm_scale=scale)
    for auto_g, man_g, want in zip((tq.grad, tk.grad, tv.grad), manual, ref):
        _assert_rel(auto_g, want, 1e-5)
        _assert_rel(man_g, want, 1e-5)


# (q [B, H, T, d], k [B, H, S, d]) of every attention site of a training
# step at reference_parity width, B=32 (text 601, mel 400, prompts 267)
SITES = [
    ((32, 8, 601, 8), (32, 8, 601, 8)),      # DP UNet level 0 self
    ((32, 8, 601, 8), (32, 8, 400, 8)),      # DP UNet level 0 cross
    ((32, 8, 301, 8), (32, 8, 301, 8)),      # DP UNet level 1 self
    ((32, 8, 301, 8), (32, 8, 400, 8)),      # DP UNet level 1 cross
    ((32, 8, 151, 16), (32, 8, 151, 16)),    # DP UNet level 2 self
    ((32, 8, 151, 16), (32, 8, 400, 16)),    # DP UNet level 2 cross
    ((32, 8, 76, 16), (32, 8, 400, 16)),     # DP UNet mid cross
    ((32, 8, 400, 16), (32, 8, 400, 16)),    # denoiser level 0 self
    ((32, 8, 400, 16), (32, 8, 267, 16)),    # denoiser level 0 cross
    ((32, 8, 200, 32), (32, 8, 200, 32)),    # denoiser level 1 self
    ((32, 8, 200, 32), (32, 8, 267, 32)),    # denoiser level 1 cross
    ((32, 8, 400, 32), (32, 8, 400, 32)),    # vits.o_proj EncSALayer
    ((32, 8, 267, 16), (32, 8, 267, 16)),    # prompt encoder EncSALayer
    ((32, 8, 400, 192), (32, 8, 400, 192)),  # head dim above 128
]


@pytest.mark.parametrize("use_flash", [True, False])
def test_flash_ok_matches_the_jax_gate(monkeypatch, use_flash):
    monkeypatch.setattr(JFA.jax, "default_backend", lambda: "tpu")
    got = [FA.flash_ok(q, k, use_flash) for q, k in SITES]
    assert got == [JFA.flash_ok(q, k, use_flash) for q, k in SITES]
    assert sum(got) == (8 if use_flash else 0)


def _count_sdpa(monkeypatch, module):
    """Count ``module``'s calls of ``sdpa``."""
    calls = [0]
    real = module.sdpa

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(module, "sdpa", counting)
    return calls


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_cross_attention_flash_route_matches_jax(monkeypatch, cross):
    rng = np.random.default_rng(int(cross))
    b, t, c, heads, dh = 2, 260, 16, 2, 8
    s, ck = (270, 12) if cross else (t, c)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    ctx = rng.normal(size=(b, s, ck)).astype(np.float32) if cross else None
    bias = None
    if cross:     # the UNet's [B, 1, S] additive key-padding bias
        keep = np.arange(s)[None] < np.array([[s], [37]])
        bias = np.where(keep, 0.0, -10000.0).astype(np.float32)[:, None]
    jm = JCrossAttention(c, heads, dh, cross_attention_dim=ck if cross
                         else None, use_flash=True)
    args = _jax(x, ctx, bias)
    tree = fill(flax_shapes(jm, *args), seed=3)
    ref = jm.apply(to_jax(tree), *args)
    pm = load(tunet.CrossAttention(c, heads, dh, ck if cross else None), tree)
    assert not pm.uses_flash(t, s)           # off by default
    tunet.set_use_flash(pm, True)
    assert pm.uses_flash(t, s)
    calls = _count_sdpa(monkeypatch, tunet)
    with torch.no_grad():
        out = pm(*_torch(x, ctx, bias))
    assert calls[0] == 1
    assert_close(out, ref, 1e-5)


def test_enc_sa_layer_flash_route_matches_jax(monkeypatch):
    rng = np.random.default_rng(5)
    b, t, c = 2, 256, 64                     # 8 heads of 8
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    keep = (np.arange(t)[None] < np.array([[t], [101]])).astype(
        np.float32)[..., None]
    jm = JEncSALayer(8, 0.0, attention_dropout=0.0, relu_dropout=0.0,
                     kernel_size=9)
    tree = fill(flax_shapes(jm, *_jax(x, keep)), seed=6)
    ref = jm.apply(to_jax(tree), *_jax(x, keep))
    pm = load(tfairseq.EncSALayer(c, 8, 9), tree)
    assert not pm.uses_flash(t, c)           # off by default
    tunet.set_use_fused(pm, True)
    assert not pm.use_flash
    tunet.set_use_flash(pm, True)
    assert pm.uses_flash(t, c) and not pm.uses_flash(255, c)
    calls = _count_sdpa(monkeypatch, tfairseq)
    with torch.no_grad():
        out = pm(*_torch(x, keep))
    assert calls[0] == 1
    assert_close(out, ref, 1e-5)
