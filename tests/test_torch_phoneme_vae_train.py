"""bv2 (the phoneme prosody VAE) through the port's entry points at tiny
widths on the CPU (its gradients against ``jax.grad``:
test_torch_phoneme_vae_grad.py):

* ``synthesize`` of the sdp + residual-flow bv2 model against JAX's on a
  ragged batch of 3 (duration draw injected, zero prior noise, injected
  initial noise, 30-step UniPC): max |mel diff| <= 5e-3, equal frame
  counts, as test_torch_variants_synthesize.py holds the variant;
* ``BatchSynthesizer`` serves bv2 (order kept, finite mels);
* ``Trainer`` trains bv2: from plain random weights the phoneme KL
  overflows at the first step (the warm-up gap shared with the JAX
  package, ROADMAP Queue 3); with the phoneme posterior's std at 1
  (``chip_smoke.unit_phoneme_posterior_std``) the losses are finite,
  ``loss/kl_ph`` non-zero, and every parameter moves."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import fill, flax_shapes, tiny_configs, to_jax
from test_torch_synthesize import GATE, ORDER, make_batch
from test_torch_trainer import _batch

torch.set_num_threads(2)

BV2 = dict(use_phoneme_vae=True, n_flow_layer=2)


def _configs(**change):
    return tuple(dataclasses.replace(c, vits=dataclasses.replace(
        c.vits, **BV2, **change)) for c in tiny_configs())


def _bv2_models(seed=1):
    jcfg, pcfg = _configs(duration_predictor="sdp", use_flow=True)
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, tx, s = 3, 8, 11
    data = make_batch(b, tx, s, seed=3)
    shapes = flax_shapes(
        jm, jnp.asarray(data["text"]), jnp.asarray(data["text_lengths"]),
        jnp.zeros((b, 20, 100)), jnp.array([20, 15, 8]),
        jnp.asarray(data["refer"]), jnp.asarray(data["refer_lengths"]),
        jnp.asarray(data["tone"]), jnp.asarray(data["language"]),
        rng=jax.random.PRNGKey(2))
    tree = fill(shapes, seed=seed)
    pm = DiffVits(pcfg, len(symbols), device="cpu")
    pm.load_state_dict(from_flax_params(tree, pcfg), strict=True)
    return jm, tree, pm, pcfg, data


def test_synthesize_bv2_matches_jax_ragged_b3():
    jm, tree, pm, _, data = _bv2_models()
    b, tx, max_len = 3, 8, 40
    key = jax.random.PRNGKey(0)
    k_prior, _ = jax.random.split(key)
    dur_noise = np.array(jax.random.normal(jax.random.fold_in(k_prior, 3),
                                           (b, tx, 2)))
    noise = np.random.default_rng(103).normal(
        size=(b, max_len, 100)).astype(np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=30, sample_method="unipc",
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(to_jax(tree),
                           *[jnp.asarray(data[k]) for k in ORDER], key=key,
                           init_noise=jnp.asarray(noise))
    mel, out_len = synthesize(
        pm.eval(), *[torch.from_numpy(data[k]) for k in ORDER],
        sampling_steps=30, noise_scale=0.0, max_len=max_len,
        init_noise=torch.from_numpy(noise),
        dur_noise=torch.from_numpy(dur_noise), device="cpu")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"max |mel diff| = {err:.2e} (gate {GATE}); frames "
          f"{out_len.tolist()}")
    assert err <= GATE, err


def test_batch_synthesizer_serves_bv2():
    _, _, pm, pcfg, _ = _bv2_models(seed=2)
    syn = BatchSynthesizer(pcfg, pm.state_dict(), batch_size=2, steps=4,
                           text_buckets=(16,), mel_buckets=(48,),
                           dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(f"u{i}", rng.integers(1, 40, n), rng.integers(0, 11, n),
             rng.integers(0, 3, n),
             rng.normal(size=(syn.refer_frames, 100)).astype(np.float32))
            for i, n in enumerate([5, 12, 9])]
    out = syn.synthesize_all(reqs, seed=0)
    assert [u for u, _ in out] == ["u0", "u1", "u2"]
    assert all(np.isfinite(m).all() and m.shape[1] == 100 and
               1 <= m.shape[0] <= 48 for _, m in out)


def test_trainer_trains_bv2():
    _, pcfg = _configs(duration_predictor="sdp", use_flow=True)
    cfg = dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, use_ema=True))
    raw = Trainer(cfg, [], device="cpu")
    raw_kl_ph = float(raw.train_step(_batch(7))["loss/kl_ph"])
    print(f"plain random weights: loss/kl_ph {raw_kl_ph}")
    assert not np.isfinite(raw_kl_ph) or raw_kl_ph > 1e20

    tr = Trainer(cfg, [], device="cpu")
    chip_smoke.unit_phoneme_posterior_std(torch, tr.model)
    p0 = [p.detach().clone() for p in tr.params]
    for seed in (7, 8):
        values = {k: float(v) for k, v in tr.train_step(_batch(seed)).items()}
        print(values)
        assert all(np.isfinite(v) for v in values.values())
        assert values["loss/kl_ph"] != 0.0
    moved = [not torch.equal(p.detach(), q) for p, q in zip(tr.params, p0)]
    assert all(moved)
