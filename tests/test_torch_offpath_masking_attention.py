"""The port's sequence helpers, functional SDPA, Gaussian Fourier
projection and value clip against the JAX package (CPU, float32).

Same numpy inputs to both packages; exact where the function is a gather
or a mask, atol = rtol = 1e-5 where it computes. ``rand_slice_segments``
draws from a ``torch.Generator`` (JAX's key stream cannot be matched): its
starts are checked for range and use, its slices through
``slice_segments``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.core import masking as jmask
from diff_vits_tpu.nn.embeddings import GaussianFourierProjection as JGFP
from diff_vits_tpu.ops import attention as jattn
from diff_vits_tpu.train.trainer import clip_grad_value as jclip
from diff_vits_tpu_torch.core import masking as tmask
from diff_vits_tpu_torch.nn.embeddings import GaussianFourierProjection
from diff_vits_tpu_torch.ops import attention as tattn
from diff_vits_tpu_torch.train.trainer import clip_grad_value
from diff_vits_tpu_torch.utils.convert import to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)
TOL = 1e-5


def test_convert_pad_shape_matches_jax():
    for shape in ([[0, 0], [1, 2], [3, 0]], [[4, 5]], []):
        assert tmask.convert_pad_shape(shape) == \
            jmask.convert_pad_shape(shape)


@pytest.mark.parametrize("t,seg", [(12, 4), (13, 5), (6, 6)])
def test_slice_segments_matches_jax_exactly(t, seg):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(3, t, 5)).astype(np.float32)
    # the last start is past t - seg: both clamp it to t - seg
    ids = np.array([0, t - seg, t - 1], np.int32)
    got = tmask.slice_segments(torch.from_numpy(x), torch.from_numpy(ids),
                               seg)
    want = jmask.slice_segments(jnp.asarray(x), jnp.asarray(ids), seg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rand_slice_segments_ranges_and_slices():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(64, 20, 3)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1, 21, 64))
    gen = torch.Generator().manual_seed(0)
    seg = 4
    out, ids = tmask.rand_slice_segments(x, lengths, seg, generator=gen)
    assert ids.dtype == torch.int32 and out.shape == (64, seg, 3)
    top = torch.clamp(lengths - seg + 1, min=1)
    assert bool(((ids >= 0) & (ids < top)).all())
    # the draws use the range: items with room start at more than one place
    assert len(set(ids[top > 8].tolist())) > 3
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jmask.slice_segments(
            jnp.asarray(x.numpy()), jnp.asarray(ids.numpy()), seg)))
    again, ids2 = tmask.rand_slice_segments(
        x, lengths, seg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ids, ids2) and torch.equal(out, again)


def test_subsequent_mask_matches_jax():
    for t in (1, 5):
        np.testing.assert_array_equal(tmask.subsequent_mask(t).numpy(),
                                      np.asarray(jmask.subsequent_mask(t)))


@pytest.mark.parametrize("t,c", [(17, 8), (9, 7), (4, 2), (3, 1)])
def test_timing_signal_matches_jax(t, c):
    # c = 7: an odd channel count pads one zero channel (masking.py:127)
    assert_close(tmask.get_timing_signal_1d(t, c),
                 jmask.get_timing_signal_1d(t, c), atol=TOL, rtol=TOL)


def _qkv(b=2, h=3, tq=6, tk=6, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]


@pytest.mark.parametrize("case", ["plain", "causal", "causal_rect", "mask",
                                  "bias_scale", "fully_masked"])
def test_sdpa_matches_jax(case):
    tq = 4 if case == "causal_rect" else 6
    q, k, v = _qkv(tq=tq, seed=len(case))
    kw, mask = {}, None
    rng = np.random.default_rng(1)
    if case.startswith("causal"):
        kw["causal"] = True
    if case in ("mask", "fully_masked"):
        mask = rng.random((2, 1, tq, 6)) > 0.4
        if case == "fully_masked":
            mask[0, 0, 2] = False      # a query row that keeps no key
    if case == "bias_scale":
        kw["scale"] = 0.3
        kw["bias"] = rng.normal(size=(1, 3, tq, 6)).astype(np.float32)
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    tkw = {k_: torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    got = tattn.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask), **tkw)
    want = jattn.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask), **jkw)
    assert bool(torch.isfinite(got).all())
    if case == "fully_masked":
        assert float(got[0, 0, 2].abs().max()) == 0.0
    assert_close(got, want, atol=TOL, rtol=TOL)


def test_attend_key_padding_matches_jax():
    q, k, v = _qkv(seed=5)
    keep = np.array([[1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]], bool)
    for causal in (False, True):
        got = tattn.attend(*map(torch.from_numpy, (q, k, v)),
                           key_padding_mask=torch.from_numpy(keep),
                           causal=causal)
        want = jattn.attend(*map(jnp.asarray, (q, k, v)),
                            key_padding_mask=jnp.asarray(keep), causal=causal)
        assert bool(torch.isfinite(got).all())
        assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("log,flip", [(True, False), (False, True)])
def test_gaussian_fourier_projection_matches_jax(log, flip):
    x = np.array([0.5, 1.0, 3.7], np.float32)
    jm = JGFP(16, scale=2.0, log=log, flip_sin_to_cos=flip)
    tree = fill(flax_shapes(jm, jnp.asarray(x)), seed=2)
    pm = load(GaussianFourierProjection(16, 2.0, log, flip), tree)
    assert not pm.weight.requires_grad
    assert set(pm.state_dict()) == {"weight"}
    assert_close(pm(torch.from_numpy(x)), jm.apply(to_jax(tree),
                                                   jnp.asarray(x)),
                 atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(to_flax_params(pm)["weight"],
                                  tree["weight"])


@pytest.mark.parametrize("clip,norm_type", [(0.5, 2.0), (None, 2.0),
                                            (1.0, 1.0)])
def test_clip_grad_value_matches_jax(clip, norm_type):
    rng = np.random.default_rng(9)
    g = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32) * 2}
    got, total = clip_grad_value({k: torch.from_numpy(v)
                                  for k, v in g.items()}, clip, norm_type)
    want, jtotal = jclip({k: jnp.asarray(v) for k, v in g.items()}, clip,
                         norm_type)
    assert total.dtype == torch.float32
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    as_list, total2 = clip_grad_value([torch.from_numpy(g["a"]),
                                       torch.from_numpy(g["b"])], clip,
                                      norm_type)
    assert isinstance(as_list, list) and float(total2) == float(total)
