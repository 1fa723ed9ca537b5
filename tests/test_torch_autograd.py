"""Gradients through the kernel routes of K1-K4.

On the card each fused op runs its CUDA kernels inside
``ops/kernel_function.KernelFunction``, whose backward recomputes the
plain version and differentiates it (the JAX package's ``custom_vjp``
through its XLA twin). Here, on the CPU, the plain forward stands in for
the kernels inside the same Function, with the weights passed as the UNet
passes them (permuted views of nn.Linear / nn.Conv1d storage). Its
gradients, landing on those leaf tensors, must equal plain autograd's
(rtol 1e-6: the same arithmetic) and match ``jax.grad`` through the JAX
package's fused ops (Pallas in interpret mode) to max |port - jax| <=
1e-4 max |jax| per input (float32 sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.ops import fused_resnet as JFR
from diff_vits_tpu.ops import fused_transformer as JFT
from diff_vits_tpu_torch.ops import fused_resnet as FR
from diff_vits_tpu_torch.ops import fused_transformer as FT
from diff_vits_tpu_torch.ops.kernel_function import KernelFunction, run_kernels

torch.set_num_threads(2)


def _arrays(seed, shapes, scales):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scales)]


def _resnet(seed):
    b, t, ci, co = 2, 19, 16, 24
    a = _arrays(seed, [(b, t, ci), (b, 2 * co), (ci,), (ci,), (3, ci, co),
                       (co,), (co,), (co,), (3, co, co), (co,), (ci, co),
                       (co,)],
                [1, 0.5, 0.1, 0.1, (3 * ci) ** -0.5, 0.1, 0.1, 0.1,
                 (3 * co) ** -0.5, 0.1, ci ** -0.5, 0.1])
    a[2], a[6] = a[2] + 1.0, a[6] + 1.0
    return a, dict(groups=8, eps=1e-5)


def _attn(seed, b, t, c, ck, s, cross):
    x, lns, lnb, wq, wk, wv, wo, bo, ctx = _arrays(
        seed, [(b, t, c), (c,), (c,), (c, c), (ck, c), (ck, c), (c, c), (c,),
               (b, s, ck)],
        [1, 0.1, 0.1, c ** -0.5, ck ** -0.5, ck ** -0.5, c ** -0.5, 0.1, 1])
    if not cross:
        return [x, lns + 1.0, lnb, wq, wk, wv, wo, bo], dict(heads=4)
    keep = (np.arange(s)[None] < np.array([[s], [s // 2], [1]])[:b])
    bias = ((1.0 - keep) * -10000.0)[:, None, :].astype(np.float32)
    return ([x, ctx, bias, lns + 1.0, lnb, wq, wk, wv, wo, bo],
            dict(heads=4))


def _geglu(seed):
    b, t, c = 2, 20, 16
    a = _arrays(seed, [(b, t, c), (c,), (c,), (c, 8 * c), (8 * c,),
                       (4 * c, c), (c,)],
                [1, 0.1, 0.1, c ** -0.5, 0.1, (4 * c) ** -0.5, 0.1])
    a[1] = a[1] + 1.0
    return a, {}


# name: (port op, its plain version, JAX op, inputs, weight positions,
#        positions of constants that take no gradient)
CASES = {
    "fused_resnet_block": (FR.fused_resnet_block, FR.fused_resnet_block_plain,
                           JFR.fused_resnet_block, lambda: _resnet(0),
                           (4, 8, 10), ()),
    "fused_self_attention": (
        FT.fused_self_attention, FT.fused_self_attention_plain,
        JFT.fused_self_attention, lambda: _attn(1, 2, 37, 32, 32, 1, False),
        (3, 4, 5, 6), ()),
    "fused_cross_attention": (
        FT.fused_cross_attention, FT.fused_cross_attention_plain,
        JFT.fused_cross_attention, lambda: _attn(2, 3, 29, 32, 16, 13, True),
        (5, 6, 7, 8), (2,)),
    "fused_geglu_ff": (FT.fused_geglu_ff, FT.fused_geglu_ff_plain,
                       JFT.fused_geglu_ff, lambda: _geglu(3), (3, 5), ()),
}


def _port_grads(fn, arrays, weights, consts, r):
    """Gradients of sum(fn(...) * r) on leaf tensors; a weight's leaf is
    its module storage ([out, in] or [out, in, k]), passed as a view."""
    leaves, args = [], []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(a)
        if i in consts:
            args.append(t)
            continue
        perm = tuple(range(a.ndim))[::-1] if i in weights else None
        leaf = (t if perm is None else t.permute(perm)).clone()
        leaf.requires_grad_(True)
        leaves.append((leaf, perm))
        args.append(leaf if perm is None else leaf.permute(perm))
    (fn(*args) * torch.from_numpy(r)).sum().backward()
    return [(leaf.grad if perm is None else leaf.grad.permute(perm)).numpy()
            for leaf, perm in leaves]


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_function_gradients_match_plain_and_jax(name):
    op, plain, jop, make, weights, consts = CASES[name]
    arrays, kw = make()
    f32 = dict(compute_dtype=torch.float32, **kw)
    fn = functools.partial(plain, **f32)
    r = np.random.default_rng(9).normal(
        size=fn(*map(torch.from_numpy, arrays)).shape).astype(np.float32)

    def through_function(*args):
        # the kernels' place in the Function taken by the plain forward
        return KernelFunction.apply(fn, fn, *args)
    got = _port_grads(through_function, arrays, weights, consts, r)
    ref = _port_grads(fn, arrays, weights, consts, r)
    assert len(got) == len(arrays) - len(consts)
    for g, p in zip(got, ref):
        np.testing.assert_allclose(g, p, rtol=1e-6, atol=0)

    var = [i for i in range(len(arrays)) if i not in consts]

    def jloss(*vs):
        args = [jnp.asarray(a) for a in arrays]
        for i, v in zip(var, vs):
            args[i] = v
        return jnp.sum(jop(*args, compute_dtype=jnp.float32, **kw)
                       * jnp.asarray(r))
    jgrads = jax.grad(jloss, argnums=tuple(range(len(var))))(
        *[jnp.asarray(arrays[i]) for i in var])
    for i, g, j in zip(var, got, jgrads):
        j = np.asarray(j)
        err = np.abs(g - j).max() / np.abs(j).max()
        print(f"{name} input {i}: max |port - jax| / max |jax| = {err:.2e}")
        assert err <= 1e-4, (i, err)


def test_run_kernels_records_only_when_a_gradient_is_needed():
    calls = []

    def kernels(x, w):
        calls.append("kernels")
        return x @ w

    def plain(x, w):
        calls.append("plain")
        return x @ w
    x, w = torch.randn(3, 4), torch.randn(4, 2)
    out = run_kernels(kernels, plain, x, w)
    assert out.grad_fn is None and calls == ["kernels"]
    w.requires_grad_(True)
    with torch.no_grad():
        assert run_kernels(kernels, plain, x, w).grad_fn is None
    out = run_kernels(kernels, plain, x, w)
    assert out.grad_fn is not None
    out.sum().backward()
    # the forward ran the kernels, the backward the plain version; x
    # needed no gradient and got none
    assert calls == ["kernels"] * 3 + ["plain"]
    assert x.grad is None
    torch.testing.assert_close(w.grad, x.sum(0)[:, None].expand(4, 2))
