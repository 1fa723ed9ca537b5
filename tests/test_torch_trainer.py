"""Port's ``Trainer`` on the CPU at the tiny widths of ``test_torch_common``.

* One ``train_step`` against the JAX trainer's own optimizer and clip
  (``make_optimizer``: optax.adamw, weight decay 1e-4;
  ``clip_by_global_norm_scheduled``) fed the same gradients, on both sides
  of ``clip_switch_step``; eps is raised to 1e-2 so that the update
  depends on the clipped gradients' scale. Parameters within rtol 1e-5
  (float32 arithmetic in another order), the pre-clip norm within rtol
  1e-5.
* The EMA update and the EMA never aliasing the parameters.
* Gradient accumulation over 2 micro-batches gives the mean of the two
  micro-batch gradients (rtol 1e-5).
* Dropout: active in train(), at its rate, from the generator passed
  down; inactive in eval().
* A checkpoint round trip, keep-N rotation, resume, the non-finite-loss
  tripwire, and no silent CPU path.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_vits_tpu.core.config import (
    Config as JConfig, TrainConfig as JTrainConfig)
from diff_vits_tpu.train import trainer as jtrainer
from diff_vits_tpu_torch.data.batch import Batch, pad_to, random_slice
from diff_vits_tpu_torch.nn.layers import dropout
from diff_vits_tpu_torch.models.encoders import TextEncoder
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.train.trainer import Trainer, device_batch
from test_torch_common import tiny_configs

torch.set_num_threads(2)


def _cfg(**train):
    _, cfg = tiny_configs()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, **train))


def _batch(seed, b=2, tx=9, ty=40, s=27):
    """A ragged Batch shaped like the loader's: mels cut by random_slice."""
    rng, py_rng = np.random.default_rng(seed), random.Random(seed)
    cut = [random_slice(rng.normal(size=(ty - 7 * i, 100)).astype(np.float32),
                        py_rng, ty, 10) for i in range(b)]
    text_len = np.array([tx - 3 * i for i in range(b)])
    keep = np.arange(tx)[None] < text_len[:, None]

    def ids(hi, lo=0):
        return rng.integers(lo, hi, (b, tx)) * keep

    def mels(k, n):
        return np.stack([pad_to(c[k], n) for c in cut])
    return Batch(text=ids(len(symbols), 1), tone=ids(11), language=ids(3),
                 spec=mels(0, ty), refer1=mels(1, s), refer2=mels(2, s),
                 text_lengths=text_len,
                 spec_lengths=np.array([len(c[0]) for c in cut]),
                 refer1_lengths=np.array([len(c[1]) for c in cut]),
                 refer2_lengths=np.array([len(c[2]) for c in cut]))


def _workdir_files(path):
    """Every file of the workdir but the tensorboard event files that
    ``train()`` writes there, so a leftover ``model-N.ckpt.tmp`` shows."""
    return sorted(p.name for p in path.iterdir()
                  if not p.name.startswith("events.out.tfevents"))


def _grads_of(trainer, micro):
    """Per micro-batch gradients of the loss that ``trainer.train_step``
    takes next, drawn from copies of its random streams; leaves the
    trainer's streams and gradients as they were."""
    gen = torch.Generator()
    gen.set_state(trainer.generator.get_state())
    py_rng = random.Random()
    py_rng.setstate(trainer._py_rng.getstate())
    scale = max(trainer.cfg.train.mas_noise_scale_initial
                - trainer.cfg.train.noise_scale_delta * trainer.step, 0.0)
    out = []
    for mb in micro:
        trainer.model.zero_grad(set_to_none=True)
        loss, _ = trainer.model(**device_batch(mb, py_rng.random() < 0.5,
                                               trainer.device),
                                generator=gen, mas_noise_scale=scale)
        loss.backward()
        out.append({n: p.grad.clone()
                    for n, p in trainer.model.named_parameters()})
    trainer.model.zero_grad(set_to_none=True)
    return out


def test_train_step_matches_optax_adamw_with_the_clip_schedule():
    cfg = _cfg(clip_switch_step=1, eps=1e-2, train_lr=1e-2)
    jcfg = JConfig(train=JTrainConfig(**dataclasses.asdict(cfg.train)))
    tr = Trainer(cfg, [], device="cpu")

    def flat(tensors):
        # one leaf: adamw is elementwise and the clip takes the global norm,
        # so the update is that of the tree (and compiles in a second)
        return jnp.asarray(np.concatenate([t.detach().numpy().ravel()
                                           for t in tensors]))
    params = flat(tr.params)
    tx = jtrainer.make_optimizer(jcfg)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(grads, opt_state, params, step):
        clipped, g_norm = jtrainer.clip_by_global_norm_scheduled(
            grads, step, jcfg)
        updates, opt_state = tx.update(clipped, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, g_norm

    for step, seed in enumerate((1, 2)):      # max_norm 10, then 1
        b = _batch(seed)
        (g,) = _grads_of(tr, [b])
        grads = flat(g[n] for n, _ in tr.model.named_parameters())
        params, opt_state, g_norm = jax_step(grads, opt_state, params,
                                             jnp.asarray(step))
        metrics = tr.train_step(b)
        assert tr.step == step + 1
        assert float(g_norm) > cfg.train.clip_before   # the clip acts
        np.testing.assert_allclose(float(metrics["loss/grad"]),
                                   float(g_norm), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(flat(tr.params)),
                                   np.asarray(params), rtol=1e-5, atol=1e-6)


def test_ema_is_a_copy_updated_after_the_step():
    cfg = _cfg(use_ema=True, ema_decay=0.9)
    tr = Trainer(cfg, [], device="cpu")
    assert all(e.untyped_storage().data_ptr()
               != p.untyped_storage().data_ptr()
               for e, p in zip(tr.ema, tr.params))
    ema0 = [e.clone() for e in tr.ema]
    p0 = [p.detach().clone() for p in tr.params]
    tr.train_step(_batch(3))
    changed = 0
    for e, e0, p, q in zip(tr.ema, ema0, tr.params, p0):
        want = e0 * 0.9 + p.detach() * (1 - 0.9)
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-7)
        changed += not torch.equal(p.detach(), q)
    assert changed == len(p0)            # every parameter moved, the EMA
    assert not any(torch.equal(e, p.detach())   # lags behind it
                   for e, p in zip(tr.ema, tr.params))


def test_accumulation_of_two_micro_batches_is_their_mean():
    cfg = _cfg(gradient_accumulate_every=2, clip_before=1e9, train_lr=0.0)
    tr = Trainer(cfg, [], device="cpu")
    micro = [_batch(4), _batch(5)]
    g1, g2 = _grads_of(tr, micro)
    with pytest.raises(ValueError, match="2 micro-batches"):
        tr.train_step(micro[0])
    tr.train_step(micro)
    for n, p in tr.model.named_parameters():
        want = (g1[n] + g2[n]) / 2
        torch.testing.assert_close(p.grad, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_dropout_rate_and_modes():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.2, True, gen)
    assert abs(float((y == 0).float().mean()) - 0.2) < 0.005
    assert torch.all((y == 0) | (y == 1 / 0.8))
    assert dropout(x, 0.2, False, gen) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, True, None)

    enc = TextEncoder(40, 8, 16, 16, 2, 2, 3, 0.1, device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 40, (2, 7)))
    args = (ids, torch.tensor([7, 4]), ids % 11, ids % 3)

    def run(seed):
        return enc(*args, generator=torch.Generator().manual_seed(seed))[1]
    enc.train()
    torch.testing.assert_close(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    enc.eval()
    torch.testing.assert_close(run(1), run(2))


def test_checkpoint_round_trip_keep_n_and_resume(tmp_path):
    cfg = _cfg(use_ema=True, keep_ckpts=2, save_and_sample_every=2)
    batches = [_batch(s) for s in range(6)]
    tr = Trainer(cfg, batches, device="cpu", workdir=str(tmp_path))
    tr.train(3, log_every=1)
    assert _workdir_files(tmp_path) == ["model-2.ckpt", "model-3.ckpt"]
    tr.save(5)
    tr.save(4)
    assert _workdir_files(tmp_path) == [
        "model-4.ckpt", "model-5.ckpt"]
    assert ckpt_lib.latest_checkpoint_path(str(tmp_path)).endswith(
        "model-5.ckpt")

    fresh = Trainer(cfg, [], device="cpu", workdir=str(tmp_path))
    assert fresh.resume_latest() and fresh.step == 5
    for (n, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    for e, f, p in zip(tr.ema, fresh.ema, fresh.params):
        torch.testing.assert_close(e, f, rtol=0, atol=0)
        assert f.untyped_storage().data_ptr() \
            != p.untyped_storage().data_ptr()
    assert torch.equal(tr.generator.get_state(), fresh.generator.get_state())
    assert tr._py_rng.getstate() == fresh._py_rng.getstate()
    # the restored optimizer continues exactly as the original
    tr.step = fresh.step
    m1, m2 = tr.train_step(batches[5]), fresh.train_step(batches[5])
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=0, atol=0, msg=k)
    for a, b in zip(tr.params, fresh.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_non_finite_loss_checkpoints_and_raises(tmp_path):
    bad = _batch(7)
    bad.spec[0, 0, 0] = np.nan
    tr = Trainer(_cfg(), [bad], device="cpu", workdir=str(tmp_path))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        tr.train(1, log_every=1)
    assert _workdir_files(tmp_path) == ["model-1.ckpt"]


def test_trainer_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(), [])
    assert Trainer(_cfg(), [], device="cpu").device.type == "cpu"
