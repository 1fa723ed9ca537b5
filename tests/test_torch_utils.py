"""The port's ``utils`` f0, content and hparams modules against the JAX
package's: ``compute_f0`` on a sine, a two-tone signal, seeded noise,
silence and a clip shorter than a frame (voiced flags equal; f0 equal but
on frames whose two best lags JAX's own correlations cannot tell apart,
within 1e-5), ``interpolate_f0``, ``f0_to_coarse`` and
``repeat_expand_2d`` bitwise, ``ContentExtractor`` with a callable, and
``merge_params`` / ``load_params_tolerant`` on a converted tiny tree, with
a mismatched shape and a missing key, in JAX's layout and in the port's
``state_dict``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import embeddings as jemb
from diff_vits_tpu.utils import content as jcontent
from diff_vits_tpu.utils import f0 as jf0
from diff_vits_tpu.utils import hparams as jhp
from diff_vits_tpu_torch.utils import content as tcontent
from diff_vits_tpu_torch.utils import f0 as tf0
from diff_vits_tpu_torch.utils import hparams as thp
from diff_vits_tpu_torch.utils.convert import convert_tree
from test_torch_common import fill, flax_shapes

torch.set_num_threads(2)

SR = 24000


def _signal(kind):
    t = np.arange(int(0.6 * SR)) / SR
    if kind == "sine":
        return 0.5 * np.sin(2 * np.pi * 220.0 * t)
    if kind == "two_tone":
        return 0.4 * np.sin(2 * np.pi * 150.0 * t) + 0.3 * np.sin(
            2 * np.pi * 375.0 * t + 0.3)
    if kind == "glide":     # voiced, then silence, then voiced again
        f = 120.0 + 200.0 * t
        w = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)
        w[int(0.2 * SR):int(0.35 * SR)] = 0.0
        return w
    if kind == "noise":
        return np.random.default_rng(3).normal(scale=0.3, size=t.shape)
    if kind == "short":     # under one frame (960 samples)
        return 0.5 * np.sin(2 * np.pi * 300.0 * t[:700])
    raise ValueError(kind)


def _top_two_gaps(wav, hop=256):
    """JAX's per-frame gap between its best and second-best normalised
    correlation in the lag window (np.correlate on its padded frames)."""
    frame_len = int(SR // jf0.f0_min) * 2
    n_frames = (max(1, 1 + (len(wav) - frame_len) // hop)
                if len(wav) >= frame_len else 1)
    wav = np.pad(wav, (0, max(0, frame_len + n_frames * hop - len(wav))))
    lo, hi = int(SR / jf0.f0_max), int(SR / jf0.f0_min)
    gaps = np.full(n_frames, np.inf)
    for i in range(n_frames):
        frame = wav[i * hop:i * hop + frame_len]
        frame = frame - frame.mean()
        corr = np.correlate(frame, frame, mode="full")[frame_len - 1:]
        seg = np.sort(corr[lo:hi] / (corr[0] + 1e-12))
        gaps[i] = seg[-1] - seg[-2]
    return gaps


@pytest.mark.parametrize("kind", ["sine", "two_tone", "glide", "noise",
                                  "short"])
def test_compute_f0_matches_jax(kind):
    wav = _signal(kind).astype(np.float32)
    ref = jf0.compute_f0(wav, SR)
    port = tf0.compute_f0(torch.from_numpy(wav), SR)
    assert port.dtype == torch.float32 and port.shape == ref.shape
    port = port.numpy()
    np.testing.assert_array_equal(port > 0, ref > 0)
    differ = port != ref
    ties = _top_two_gaps(wav) <= 1e-5
    print(f"{kind}: {len(ref)} frames, {(ref > 0).sum()} voiced, "
          f"{differ.sum()} f0 differ, {ties.sum()} near-ties")
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
    if kind in ("sine", "two_tone"):
        assert (ref > 0).all()


def test_interpolate_f0_and_coarse_match_jax_bitwise():
    rng = np.random.default_rng(5)
    f0 = rng.uniform(60.0, 900.0, size=200).astype(np.float32)
    f0[rng.random(200) < 0.4] = 0.0
    f0[:7] = 0.0                                  # unvoiced head and tail
    f0[-5:] = 0.0
    cases = [f0, np.zeros(9, np.float32), np.array([0, 0, 180.0, 0],
                                                   np.float32),
             np.array([1100.0, 40.0, 0.0, 2000.0], np.float32)]
    for f in cases:
        ref, ref_vuv = jf0.interpolate_f0(f)
        port, port_vuv = tf0.interpolate_f0(torch.from_numpy(f))
        assert port.dtype == torch.float32 and port_vuv.dtype == \
            torch.float32
        np.testing.assert_array_equal(port.numpy(), ref)
        np.testing.assert_array_equal(port_vuv.numpy(), ref_vuv)
        coarse = tf0.f0_to_coarse(torch.from_numpy(f))
        assert coarse.dtype == torch.int64
        np.testing.assert_array_equal(coarse.numpy(), jf0.f0_to_coarse(f))
        np.testing.assert_array_equal(
            tf0.f0_to_coarse(port).numpy(), jf0.f0_to_coarse(ref))


@pytest.mark.parametrize("src,target", [(7, 19), (19, 7), (5, 5), (1, 4),
                                        (50, 201)])
def test_repeat_expand_2d_matches_jax_bitwise(src, target):
    content = np.random.default_rng(src).normal(size=(3, src)).astype(
        np.float32)
    port = tcontent.repeat_expand_2d(torch.from_numpy(content), target)
    np.testing.assert_array_equal(
        port.numpy(), jcontent.repeat_expand_2d(content, target))


def test_content_extractor_calls_its_callable():
    seen = []

    def fn(wav):
        seen.append(wav.dtype)
        return tcontent.repeat_expand_2d(wav[None].repeat(4, 1), 10)

    out = tcontent.ContentExtractor(fn)(np.arange(6, dtype=np.float64))
    assert seen == [torch.float32] and out.shape == (4, 10)
    with pytest.raises(RuntimeError, match="no content model"):
        tcontent.ContentExtractor()(np.zeros(3))


def _trees():
    """Two filled trees of a tiny JAX module (dense kernels, biases, a
    layer norm), and a third with one leaf reshaped and one removed."""
    jm = jemb.TextTimeEmbedding(16, 24, num_heads=4)
    shapes = flax_shapes(jm, jnp.zeros((2, 5, 16)))
    a, b = fill(shapes, seed=1), fill(shapes, seed=2)
    c = fill(shapes, seed=3)
    c["proj"]["kernel"] = c["proj"]["kernel"][:-1]
    del c["norm1"]["bias"]
    return a, b, c


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_merge_params_matches_jax():
    a, b, _ = _trees()
    for weights in (None, [0.25, 0.75]):
        ref = jhp.merge_params([a, b], weights)
        # JAX's layout, numpy leaves: the same tree, bitwise
        port = thp.merge_params([a, b], weights)
        assert [k for k, _ in _leaves(port)] == [k for k, _ in _leaves(ref)]
        for (_, p), (_, r) in zip(_leaves(port), _leaves(ref)):
            assert isinstance(p, np.ndarray) and p.dtype == np.float32
            np.testing.assert_array_equal(p, r)
        # the port's state_dict layout, tensor leaves
        sd = thp.merge_params([convert_tree(a), convert_tree(b)], weights)
        want = convert_tree(ref)
        assert list(sd) == list(want)
        for k, v in want.items():
            assert isinstance(sd[k], torch.Tensor)
            torch.testing.assert_close(sd[k], v, atol=0, rtol=0)


def test_load_params_tolerant_matches_jax():
    a, _, c = _trees()
    ref = jhp.load_params_tolerant(a, c)
    kept = {("proj", "kernel"), ("norm1", "bias")}
    for (k, r), (_, av), (_, p) in zip(_leaves(ref), _leaves(a),
                                       _leaves(thp.load_params_tolerant(
                                           a, c))):
        assert isinstance(p, np.ndarray)
        np.testing.assert_array_equal(p, r)
        if k in kept:
            np.testing.assert_array_equal(r, av)
    # the port's layout: state_dicts, a tensor target and a numpy save
    target = convert_tree(a)
    saved = {k: v.numpy() for k, v in convert_tree(
        {**c, "proj": {"bias": c["proj"]["bias"]}}).items()}
    saved["proj.weight"] = saved["proj.bias"][:, None]     # wrong shape
    out = thp.load_params_tolerant(target, saved)
    want = convert_tree(ref)
    assert list(out) == list(target)
    for k, v in want.items():
        assert isinstance(out[k], torch.Tensor)
        torch.testing.assert_close(out[k], v, atol=0, rtol=0)
    # a nested target takes a flat save of the same tree
    nested = thp.load_params_tolerant(
        a, {".".join(k): v for k, v in _leaves(c)})
    for (_, p), (_, r) in zip(_leaves(nested), _leaves(ref)):
        np.testing.assert_array_equal(p, r)


def test_hparams_is_an_attribute_dict():
    hp = thp.HParams(**{"train": {"lr": 1e-4, "betas": [0.8, 0.99]},
                        "seed": 3})
    ref = jhp.HParams(**{"train": {"lr": 1e-4, "betas": [0.8, 0.99]},
                         "seed": 3})
    assert hp.train.lr == hp["train"]["lr"] == ref.train.lr
    assert "seed" in hp and len(hp) == len(ref) == 2
    assert list(hp.keys()) == list(ref.keys())
    hp["model"] = 5
    assert hp.model == 5 and repr(hp.train) == repr(ref.train)
