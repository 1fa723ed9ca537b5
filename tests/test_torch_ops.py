"""Port's fused UNet ops (K1-K4) on the CPU against the JAX package.

On a CPU tensor each port op runs its plain PyTorch version. It is held
against the JAX Pallas function in interpret mode (the default off-TPU)
at atol 3e-5 / rtol 3e-4 in float32, the tolerance of
tests/test_fused_resnet.py, and against the JAX package's XLA twin of the
same math. The bf16 cases hold the port's plain version to the XLA twin
with the same compute dtype (the same operand roundings): observed error
~1 bf16 ulp of the output, bounded here at 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.ops import fused_resnet as JFR
from diff_vits_tpu.ops import fused_transformer as JFT
from diff_vits_tpu_torch.ops import fused_resnet as FR
from diff_vits_tpu_torch.ops import fused_transformer as FT

torch.set_num_threads(2)

F32_TOL = dict(atol=3e-5, rtol=3e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _arrays(seed, *shapes, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scales)]


def _t(a, dt=torch.float32):
    return torch.from_numpy(a).to(dt)


def _j(a, dt=jnp.float32):
    return jnp.asarray(a).astype(dt)


def _close(port, ref, tol):
    """allclose; prints the max |port - jax| seen (``pytest -rP``)."""
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    print(f"max |port - jax| = {np.abs(port - ref).max():.2e} ({tol})")
    np.testing.assert_allclose(port, ref, **tol)


def _resnet_inputs(b, t, ci, co, shortcut, seed=0):
    shapes = [(b, t, ci), (b, 2 * co), (ci,), (ci,), (3, ci, co), (co,),
              (co,), (co,), (3, co, co), (co,)]
    scales = [1, 0.5, 0.1, 0.1, (3 * ci) ** -0.5, 0.1, 0.1, 0.1,
              (3 * co) ** -0.5, 0.1]
    if shortcut:
        shapes += [(ci, co), (co,)]
        scales += [ci ** -0.5, 0.1]
    a = _arrays(seed, *shapes, scales=scales)
    for i in (2, 6):     # GroupNorm scales around 1
        a[i] = a[i] + 1.0
    return a


@pytest.mark.parametrize("b,t,ci,co,groups", [
    (2, 19, 16, 24, 8),     # 1x1 shortcut
    (2, 19, 16, 16, 4),     # identity shortcut
    (1, 5, 32, 16, 8),      # shortcut, fewer frames than groups' width
])
def test_resnet_block_matches_pallas_and_twin(b, t, ci, co, groups):
    a = _resnet_inputs(b, t, ci, co, ci != co)
    sc = a[10:] if ci != co else [None, None]
    kw = dict(groups=groups, eps=1e-5)
    port = FR.fused_resnet_block(*map(_t, a[:10]),
                                 *[None if s is None else _t(s) for s in sc],
                                 compute_dtype=torch.float32, **kw)
    jargs = list(map(_j, a[:10])) + [None if s is None else _j(s)
                                     for s in sc]
    pallas = JFR.fused_resnet_block(*jargs, compute_dtype=jnp.float32, **kw)
    _close(port, pallas, F32_TOL)
    if sc[0] is None:
        jargs[10:] = [jnp.zeros((ci, co)), jnp.zeros((co,))]
    twin = JFR._xla_twin(*jargs, shortcut=sc[0] is not None,
                         cdt=jnp.float32, **kw)
    _close(port, twin, F32_TOL)


def test_resnet_block_bf16_matches_twin():
    b, t, ci, co = 2, 23, 32, 16
    a = _resnet_inputs(b, t, ci, co, True, seed=3)
    tdt, jdt = DT["bfloat16"]
    cast = {0, 4, 8, 10}   # x and the weights in the compute dtype
    port = FR.fused_resnet_block(
        *[_t(v, tdt if i in cast else torch.float32)
          for i, v in enumerate(a)],
        groups=8, eps=1e-5, compute_dtype=tdt)
    twin = JFR._xla_twin(*[_j(v, jdt if i in cast else jnp.float32)
                           for i, v in enumerate(a)],
                         groups=8, eps=1e-5, shortcut=True, cdt=jdt)
    assert port.dtype == torch.bfloat16
    _close(port, twin, BF16_TOL)


def _attn_inputs(b, t, c, ck, s, seed):
    x, lns, lnb, wq, wk, wv, wo, bo, ctx = _arrays(
        seed, (b, t, c), (c,), (c,), (c, c), (ck, c), (ck, c), (c, c), (c,),
        (b, s, ck), scales=[1, 0.1, 0.1, c ** -0.5, ck ** -0.5, ck ** -0.5,
                            c ** -0.5, 0.1, 1])
    return x, lns + 1.0, lnb, wq, wk, wv, wo, bo, ctx


def _jax_self_twin(x, lns, lnb, wq, wk, wv, wo, bo, heads, cdt):
    xf = x.astype(jnp.float32)
    h = JFT._ln_f32_batched(xf, lns[None, None], lnb[None, None])
    o = JFT._xla_mha(h, h, wq, wk, wv, wo, bo, None, heads, cdt)
    return (xf + o).astype(x.dtype)


def _jax_cross_twin(x, ctx, bias, lns, lnb, wq, wk, wv, wo, bo, heads, cdt):
    xf = x.astype(jnp.float32)
    h = JFT._ln_f32_batched(xf, lns[None, None], lnb[None, None])
    o = JFT._xla_mha(h, ctx.astype(jnp.float32), wq, wk, wv, wo, bo, bias,
                     heads, cdt)
    return (xf + o).astype(x.dtype)


@pytest.mark.parametrize("b,t,c,heads", [
    (2, 37, 32, 4),     # d = 8
    (1, 21, 24, 2),     # d = 12: not a power of two
    (2, 9, 48, 1),      # d = 48
])
def test_self_attention_matches_pallas_and_twin(b, t, c, heads):
    x, lns, lnb, wq, wk, wv, wo, bo, _ = _attn_inputs(b, t, c, c, 1, seed=t)
    args = (x, lns, lnb, wq, wk, wv, wo, bo)
    port = FT.fused_self_attention(*map(_t, args), heads=heads,
                                   compute_dtype=torch.float32)
    jargs = list(map(_j, args))
    _close(port, JFT.fused_self_attention(*jargs, heads=heads,
                                          compute_dtype=jnp.float32),
           F32_TOL)
    _close(port, _jax_self_twin(*jargs, heads, jnp.float32), F32_TOL)


@pytest.mark.parametrize("b,t,c,ck,s,heads", [
    (3, 29, 32, 16, 13, 4),    # ragged keys: lengths 13, 7, 1
    (2, 8, 24, 40, 31, 2),     # d = 12, wide keys
])
def test_cross_attention_matches_pallas_and_twin(b, t, c, ck, s, heads):
    x, lns, lnb, wq, wk, wv, wo, bo, ctx = _attn_inputs(b, t, c, ck, s,
                                                        seed=s)
    lengths = np.array([s, max(1, s // 2), 1][:b])
    keep = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    bias = ((1.0 - keep) * -10000.0)[:, None, :].astype(np.float32)
    args = (x, ctx, bias, lns, lnb, wq, wk, wv, wo, bo)
    port = FT.fused_cross_attention(*map(_t, args), heads=heads,
                                    compute_dtype=torch.float32)
    jargs = list(map(_j, args))
    _close(port, JFT.fused_cross_attention(*jargs, heads=heads,
                                           compute_dtype=jnp.float32),
           F32_TOL)
    _close(port, _jax_cross_twin(*jargs, heads, jnp.float32), F32_TOL)


def test_attention_bf16_matches_twin():
    tdt, jdt = DT["bfloat16"]
    x, lns, lnb, wq, wk, wv, wo, bo, ctx = _attn_inputs(2, 17, 32, 16, 9, 5)
    keep = (np.arange(9)[None] < np.array([[9], [4]])).astype(np.float32)
    bias = ((1.0 - keep) * -10000.0)[:, None, :].astype(np.float32)
    w = (wq, wk, wv, wo)
    port = FT.fused_cross_attention(
        _t(x, tdt), _t(ctx, tdt), _t(bias), _t(lns), _t(lnb),
        *[_t(v, tdt) for v in w], _t(bo), heads=4, compute_dtype=tdt)
    twin = _jax_cross_twin(_j(x, jdt), _j(ctx, jdt), _j(bias), _j(lns),
                           _j(lnb), *[_j(v, jdt) for v in w], _j(bo), 4, jdt)
    _close(port, twin, BF16_TOL)
    wk2 = _arrays(6, (32, 32), scales=[32 ** -0.5])[0]
    ws = (wq, wk2, wk2, wo)
    port = FT.fused_self_attention(_t(x, tdt), _t(lns), _t(lnb),
                                   *[_t(v, tdt) for v in ws], _t(bo),
                                   heads=4, compute_dtype=tdt)
    twin = _jax_self_twin(_j(x, jdt), _j(lns), _j(lnb),
                          *[_j(v, jdt) for v in ws], _j(bo), 4, jdt)
    _close(port, twin, BF16_TOL)


def _ff_inputs(b, t, c, seed):
    x, lns, lnb, w1, b1, w2, b2 = _arrays(
        seed, (b, t, c), (c,), (c,), (c, 8 * c), (8 * c,), (4 * c, c), (c,),
        scales=[1, 0.1, 0.1, c ** -0.5, 0.1, (4 * c) ** -0.5, 0.1])
    return x, lns + 1.0, lnb, w1, b1, w2, b2


def _jax_ff_twin(x, lns, lnb, w1, b1, w2, b2, cdt):
    xf = x.astype(jnp.float32)
    h = JFT._ln_f32_batched(xf, lns[None, None], lnb[None, None])
    h1 = jnp.einsum("btc,cd->btd", h.astype(cdt), w1.astype(cdt),
                    preferred_element_type=jnp.float32) + b1[None, None]
    inner = h1.shape[-1] // 2
    g = h1[..., :inner] * JFT._gelu_exact(h1[..., inner:])
    o = jnp.einsum("btd,dc->btc", g.astype(cdt), w2.astype(cdt),
                   preferred_element_type=jnp.float32) + b2[None, None]
    return (xf + o).astype(x.dtype)


@pytest.mark.parametrize("b,t,c", [
    (2, 200, 16),    # T not a multiple of the 128-frame Pallas tile
    (1, 7, 24),
])
def test_geglu_ff_matches_pallas_and_twin(b, t, c):
    args = _ff_inputs(b, t, c, seed=t)
    port = FT.fused_geglu_ff(*map(_t, args), compute_dtype=torch.float32)
    jargs = list(map(_j, args))
    _close(port, JFT.fused_geglu_ff(*jargs, compute_dtype=jnp.float32),
           F32_TOL)
    _close(port, _jax_ff_twin(*jargs, jnp.float32), F32_TOL)


def test_geglu_ff_bf16_matches_twin():
    tdt, jdt = DT["bfloat16"]
    x, lns, lnb, w1, b1, w2, b2 = _ff_inputs(2, 33, 16, seed=9)
    port = FT.fused_geglu_ff(_t(x, tdt), _t(lns), _t(lnb), _t(w1, tdt),
                             _t(b1), _t(w2, tdt), _t(b2), compute_dtype=tdt)
    twin = _jax_ff_twin(_j(x, jdt), _j(lns), _j(lnb), _j(w1, jdt), _j(b1),
                        _j(w2, jdt), _j(b2), jdt)
    _close(port, twin, BF16_TOL)


def test_cuda_route_rejects_unsupported_device():
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        FT.fused_geglu_ff(x, x[0, 0], x[0, 0], x, x, x, x)
