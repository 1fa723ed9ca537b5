"""The rest of the port's ``Trainer.train`` on the CPU at tiny widths, from
a dataset on disk (seeded with numpy under ``tmp_path``):

* the constructor's dataset and loader (native when it builds, as JAX's
  ``_make_loader`` chooses);
* the prefetch thread: 4 steps' metrics and the refer1/refer2 coin flips
  bitwise equal with it on and off, the worker joined when the loop ends
  (also when the loop stops early), its errors raised on the caller;
* SIGTERM mid-loop: a checkpoint at the next step boundary, the handlers
  restored, ``resume_latest`` going on (as tests/test_preemption.py shows
  for JAX);
* a step that raises leaves a checkpoint and the original error goes on,
  also when that checkpoint fails;
* ``eval_sample``: ``sample-1.mel.npy`` and the metric keys of JAX's
  ``eval_sample`` (tests/test_eval_metrics.py), a deterministic
  ``eval_fixed_t_loss``; the tensorboardX event file holds the scalar
  tags.
"""
import dataclasses
import inspect
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from diff_vits_tpu.train import trainer as jtrainer
from diff_vits_tpu_torch.core.config import (
    Config, DataConfig, DiffusionEncoderConfig, TrainConfig, VitsConfig)
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_common import TINY_DIFF, TINY_VITS

torch.set_num_threads(2)


def write_mel_corpus(root, n=8, seed=0):
    """``n`` utterances of 14-60 frames with ``.mel.npy`` sidecars and
    cleaned EN lines of 3-8 phones (a placeholder wav each)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        base = os.path.join(root, f"u{i}")
        np.save(base + ".mel.npy", (rng.normal(size=(
            int(rng.integers(14, 60)), 100)) - 4.0).astype(np.float32))
        k = int(rng.integers(3, 9))
        phones = " ".join(symbols[int(j)] for j in rng.integers(1, 60, k))
        with open(base + ".txt", "w", encoding="utf-8") as f:
            f.write(f"EN|x|{phones}|{' '.join('0' * k)}|"
                    f"{' '.join('1' * k)}\n")
        with open(base + ".wav", "wb") as f:
            f.write(b"RIFF")
    return root


def tiny_cfg(data_root, **train):
    """The tiny model of test_torch_common on ``data_root``: batch 2, text
    buffer 2 x 12 + 1, mel 40 frames, float32."""
    base = dict(train_batch_size=2, compute_dtype="float32", seed=3,
                save_and_sample_every=10_000)
    base.update(train)
    return Config(vits=VitsConfig(**TINY_VITS),
                  diffusion_encoder=DiffusionEncoderConfig(**TINY_DIFF),
                  data=DataConfig(training_files=data_root,
                                  val_files=data_root, max_text_len=12,
                                  max_mel_len=40, min_mel_len=10),
                  train=TrainConfig(**base))


@pytest.fixture()
def data_root(tmp_path):
    return write_mel_corpus(str(tmp_path / "data"))


def _recording(trainer):
    """Record each step's metrics and coin flips."""
    flips, steps = [], []
    rng_random = trainer._py_rng.random

    def flip():
        flips.append(rng_random())
        return flips[-1]
    trainer._py_rng.random = flip
    step_on = trainer.step_on

    def recorded(micro):
        out = step_on(micro)
        steps.append({k: v.clone() for k, v in out.items()})
        return out
    trainer.step_on = recorded
    return flips, steps


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "trainer-prefetch" and t.is_alive()]


def test_loader_from_the_dataset_and_prefetch_on_off_equal(data_root,
                                                           tmp_path):
    runs = {}
    for prefetch in (True, False):
        tr = Trainer(tiny_cfg(data_root), device="cpu",
                     workdir=str(tmp_path / f"run{prefetch}"))
        assert tr.loader_kind in ("native", "python")
        assert len(tr.ds) == 8
        runs[prefetch] = _recording(tr)
        tr.train(4, log_every=1, prefetch=prefetch)
        assert tr.step == 4 and not _prefetch_threads()
    (flips_on, on), (flips_off, off) = runs[True], runs[False]
    assert flips_on == flips_off and len(flips_on) == 4
    assert len(on) == len(off) == 4
    for a, b in zip(on, off):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_prefetch_worker_stops_early_and_raises_on_the_caller(data_root):
    tr = Trainer(tiny_cfg(data_root), device="cpu")

    def endless():
        while True:
            yield from tr.batches
    it = tr.device_batches(endless(), prefetch=True)
    first = next(it)
    assert first[0]["spec"].shape == (2, 40, 100)
    time.sleep(0.2)                 # the worker fills its queue and waits
    it.close()
    assert not _prefetch_threads()

    def failing():
        yield from [next(iter(tr.batches))] * 2
        raise RuntimeError("bad shard")
    it = tr.device_batches(failing(), prefetch=True)
    next(it), next(it)
    with pytest.raises(RuntimeError, match="bad shard"):
        next(it)
    assert not _prefetch_threads()


def test_sigterm_checkpoints_at_the_step_boundary_and_resumes(data_root,
                                                              tmp_path):
    workdir = str(tmp_path / "run")
    tr = Trainer(tiny_cfg(data_root), device="cpu", workdir=workdir)
    started = threading.Event()
    step_on = tr.step_on

    def step(micro):
        started.set()
        return step_on(micro)
    tr.step_on = step

    def kill_when_started():
        assert started.wait(timeout=120)
        os.kill(os.getpid(), signal.SIGTERM)
    killer = threading.Thread(target=kill_when_started, daemon=True)
    killer.start()
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    tr.train(num_steps=10_000, log_every=1000)
    killer.join(timeout=10)
    assert not killer.is_alive()
    path = ckpt_lib.latest_checkpoint_path(workdir)
    saved, _ = ckpt_lib.load_checkpoint(path)
    assert 1 <= saved == tr.step < 10_000
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == before

    fresh = Trainer(tiny_cfg(data_root), device="cpu", workdir=workdir)
    assert fresh.resume_latest() and fresh.step == saved
    fresh.train(num_steps=saved + 2, log_every=1)
    assert fresh.step == saved + 2


def test_a_failing_step_leaves_a_checkpoint_and_reraises(data_root,
                                                         tmp_path):
    workdir = str(tmp_path / "run")
    tr = Trainer(tiny_cfg(data_root), device="cpu", workdir=workdir)
    step_on = tr.step_on

    def step(micro):
        if tr.step == 1:
            raise RuntimeError("device lost")
        return step_on(micro)
    tr.step_on = step
    with pytest.raises(RuntimeError, match="device lost"):
        tr.train(5, log_every=1)
    assert sorted(p for p in os.listdir(workdir)
                  if p.endswith(".ckpt")) == ["model-1.ckpt"]
    assert not _prefetch_threads()

    def broken_save(step):
        raise OSError("disk full")
    tr.save = broken_save
    with pytest.raises(RuntimeError, match="device lost"):
        tr.train(5, log_every=1)


def test_eval_sample_emits_jax_metric_keys_and_tensorboard_scalars(
        data_root, tmp_path, capsys):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    workdir = str(tmp_path / "run")
    tr = Trainer(tiny_cfg(data_root, save_and_sample_every=2), device="cpu",
                 workdir=workdir)
    tr.train(2, log_every=1)
    m = tr.last_eval_metrics
    # the keys of JAX's eval_sample: eval_fixed_t_loss's grid, its mean,
    # mel L1 and correlation (no EMA in this config)
    fracs = inspect.signature(jtrainer.Trainer.eval_fixed_t_loss) \
        .parameters["t_fracs"].default
    assert set(m) == {f"eval/diff_t{f:g}" for f in fracs} | {
        "eval/diff_fixed_t", "eval/mel_l1", "eval/mel_corr"}
    assert all(np.isfinite(v) for v in m.values())
    assert m["eval/mel_l1"] > 0.0 and -1.0 <= m["eval/mel_corr"] <= 1.0
    out = capsys.readouterr().out
    assert "eval step 2 " in out and "mel_l1=" in out
    mel = np.load(os.path.join(workdir, "sample-1.mel.npy"))
    assert mel.ndim == 2 and mel.shape[1] == 100 and 1 <= len(mel) <= 40
    assert np.isfinite(mel).all()
    # fixed t and noise: the eval loss repeats exactly
    again = tr.eval_fixed_t_loss(tr._eval_batch())
    for k in again:
        assert again[k] == m[k], k
    # the eval batch is one utterance, its refer1 the prompt
    assert tr._eval_batch().spec.shape == (1, 40, 100)

    acc = EventAccumulator(workdir)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"loss/all", "loss/diff", "loss/grad", "perf/steps_per_sec",
            "eval/mel_l1", "eval/mel_corr", "eval/diff_fixed_t"} <= tags
    assert [e.step for e in acc.Scalars("loss/all")] == [1, 2]
    assert {"gen/mel", "gt/mel"} <= set(acc.Tags()["images"])


def test_eval_on_given_batches_needs_a_dataset(data_root, tmp_path):
    """``Trainer(cfg, batches)`` evaluates only on a dataset it is given."""
    cfg = tiny_cfg(data_root, save_and_sample_every=1)
    src = Trainer(cfg, device="cpu")
    batches = [next(iter(src.batches))] * 2
    workdir = str(tmp_path / "run")
    tr = Trainer(cfg, batches, device="cpu", workdir=workdir)
    assert tr.loader_kind == "given" and tr.ds is None
    tr.train(2, log_every=1)
    assert not [p for p in os.listdir(workdir) if p.startswith("sample")]
    tr = Trainer(cfg, batches, dataset=src.ds, device="cpu", workdir=workdir)
    tr.train(1, log_every=1)
    assert os.path.exists(os.path.join(workdir, "sample-1.mel.npy"))
    assert dataclasses.is_dataclass(tr._eval_batch())
