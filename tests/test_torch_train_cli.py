"""The port's training command line on the CPU, end to end at tiny widths:
seeded wavs and cleaned transcripts under ``tmp_path``, the port's
``data.preprocess`` on them, then ``train.cli.main`` with ``--device cpu``
(4 steps, a checkpoint and ``eval_sample`` every 2, a vocoder in the
published layout so each sample also becomes a wav), then ``--resume
auto``; a JAX trainer state given to ``--resume`` resumes (its step, the
resume line, a step more), and one whose params do not fit the
configuration is refused naming the keys; without a card and without
``--device`` the command line and ``Trainer`` raise."""
import json
import os

import numpy as np
import pytest
import torch

from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu_torch.data import audio, preprocess
from diff_vits_tpu_torch.train import cli
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_trainer_loop import tiny_cfg
from test_torch_vocoder import _as_torch, _published_state_dict

torch.set_num_threads(2)


def write_wav_corpus(root, n=6, seed=0):
    """``n`` 0.2-0.5 s 22.05 kHz wavs (summed sines and noise) with
    cleaned EN transcripts of 3-7 phones."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    phones = ["hh", "eh", "l", "ow", "w", "er", "d", "ae", "k", "t"]
    for i in range(n):
        sr = 22050
        t = np.arange(int(rng.uniform(0.2, 0.5) * sr)) / sr
        wav = sum(0.2 * np.sin(2 * np.pi * f * t)
                  for f in rng.uniform(100, 900, 3))
        wav = wav + 0.01 * rng.normal(size=t.shape)
        audio.write_wav(os.path.join(root, f"u{i}.wav"),
                        wav.astype(np.float32), sr)
        k = int(rng.integers(3, 8))
        line = "EN|x|{}|{}|{}".format(
            " ".join(phones[j] for j in rng.integers(0, len(phones), k)),
            " ".join("0" * k), " ".join("1" * k))
        with open(os.path.join(root, f"u{i}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(line + "\n")


@pytest.fixture(scope="module")
def run_config(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    raw, processed = str(tmp / "raw"), str(tmp / "processed")
    write_wav_corpus(raw)
    preprocess.main(["--in_dir", raw, "--out_dir", processed,
                     "--language", "EN", "--cleaned", "--no_spec"])
    voc = str(tmp / "vocos.bin")
    torch.save(_as_torch(_published_state_dict(512, 1536, 8)), voc)
    cfg = tiny_cfg(processed, save_and_sample_every=2, vocoder_ckpt=voc,
                   keep_ckpts=0)
    path = str(tmp / "config.json")
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    return path, tmp


def test_preprocess_then_train_then_resume(run_config, capsys):
    cfg_path, tmp = run_config
    workdir = str(tmp / "run")
    args = ["-c", cfg_path, "--workdir", workdir, "--log_every", "2",
            "--device", "cpu"]
    trainer = cli.main([*args, "--steps", "4"])
    out = capsys.readouterr().out
    assert trainer.step == 4 and trainer.device.type == "cpu"
    assert "loader: " in out and trainer.loader_kind in ("native", "python")
    assert "step 2 " in out and "step 4 " in out and "eval step 4 " in out
    names = set(os.listdir(workdir))
    assert {"model-2.ckpt", "model-4.ckpt", "sample-1.mel.npy",
            "sample-2.mel.npy", "sample-1.wav", "sample-2.wav"} <= names
    wav, sr = audio.read_wav(os.path.join(workdir, "sample-2.wav"))
    mel = np.load(os.path.join(workdir, "sample-2.mel.npy"))
    assert sr == 24000 and len(wav) == (len(mel) - 1) * 256
    assert {"eval/mel_l1", "eval/mel_corr", "eval/diff_fixed_t"} <= set(
        trainer.last_eval_metrics)

    spans = tmp / "spans.json"
    trainer = cli.main([*args, "--resume", "auto", "--steps", "6",
                        "--trace_out", str(spans)])
    out = capsys.readouterr().out
    events = json.loads(spans.read_text())["traceEvents"]
    assert [e["args"]["step"] for e in events
            if e["name"] == "dvt.train.step"] == [5, 6]
    assert f"resumed from {os.path.join(workdir, 'model-4.ckpt')} at step 4" \
        in out
    assert trainer.step == 6 and "step 6 " in out
    assert {"model-6.ckpt", "sample-3.mel.npy", "sample-3.wav"} <= set(
        os.listdir(workdir))


def test_resume_of_a_jax_trainer_state_is_refused(run_config):
    """A JAX trainer state of another model: its params do not fit."""
    cfg_path, tmp = run_config
    state = {"params": {"w": np.ones((2, 2), np.float32)},
             "opt_state": {"0": {"count": np.zeros((), np.int32)}}}
    path = jckpt.save_checkpoint(str(tmp / "jax"), 7, state, keep=0)
    with pytest.raises(ValueError, match=r"do not fit this configuration"):
        cli.main(["-c", cfg_path, "--workdir", str(tmp / "jaxrun"),
                  "--resume", path, "--steps", "1", "--device", "cpu"])


def test_resume_of_a_jax_trainer_state(run_config, capsys):
    """A trainer state written by JAX's save_checkpoint (params of this
    configuration, optax.adamw's state of them, the EMA) at step 7 resumes
    through ``--resume`` and trains on to step 8."""
    import optax
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.utils.convert import to_flax_params
    cfg_path, tmp = run_config
    params = to_flax_params(Trainer(load_config(cfg_path), [],
                                    device="cpu").model)
    state = {"params": params, "opt_state": optax.adamw(1e-4).init(params),
             "ema_params": params}
    path = jckpt.save_checkpoint(str(tmp / "jax_ok"), 7, state, keep=0)
    trainer = cli.main(["-c", cfg_path, "--workdir", str(tmp / "jaxrun_ok"),
                        "--resume", path, "--steps", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"resumed from {path} at step 7" in out
    assert trainer.step == 8
    assert "model-8.ckpt" in os.listdir(tmp / "jaxrun_ok")


def test_no_card_and_no_device_raises(run_config, monkeypatch):
    cfg_path, tmp = run_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-c", cfg_path, "--workdir", str(tmp / "x"),
                  "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny_cfg(str(tmp / "processed")))
