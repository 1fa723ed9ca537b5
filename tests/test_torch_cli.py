"""The port's ``tts_infer`` command line on the CPU (``--device cpu``) at the
tiny config, from a checkpoint the JAX package wrote (its
``train/checkpoint.save_checkpoint`` of a trainer state), a seeded 24 kHz
prompt wav and English text (no CMU dictionary: every word through
``english_lts``): the mel and the wav are written, the mel has the frame
count the JAX package's ``tts_infer`` writes for the same checkpoint,
text and wav (the tiny config's UNet duration predictor is deterministic),
the wav (n - 1) x hop samples; ``load_refer_mel`` equals JAX's; unknown
samplers and flags are refused, and no device and no card raises. The
``serve`` command line is in tests/test_torch_cli_serve.py."""
import json
import sys

import numpy as np
import pytest
import torch

from diff_vits_tpu.data import audio as jaudio
from diff_vits_tpu.infer import tts_infer as jtts
from diff_vits_tpu.text import frontend as jfe
from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.infer import tts_infer
from diff_vits_tpu_torch.text import frontend as tfe
from test_torch_ckpt_msgpack import _trainer_state
from test_torch_common import tiny_configs
from test_torch_synthesize import tiny_models

torch.set_num_threads(2)

TEXT = "Hello world, this is a test of 12 words."


def write_wav(path, seconds, seed, sr=24000):
    """A seeded int16 wav: two tones under noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330
                                                              * t)
           + 0.05 * rng.normal(size=t.shape))
    jaudio.write_wav(str(path), wav.astype(np.float32), sr)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(config json, a JAX-written checkpoint, a prompt wav) of the tiny
    model."""
    d = tmp_path_factory.mktemp("cli")
    jcfg, _ = tiny_configs()
    cfg_path = d / "config.json"
    cfg_path.write_text(json.dumps(jcfg.to_dict()))
    _, jparams, _ = tiny_models(seed=3)
    ckpt = jckpt.save_checkpoint(str(d / "run"), 20,
                                 _trainer_state(jparams["params"]), keep=0)
    return str(cfg_path), ckpt, write_wav(d / "prompt.wav", 0.6, seed=1)


@pytest.fixture
def no_cmudict(monkeypatch, tmp_path):
    monkeypatch.setenv("DIFF_VITS_CMUDICT", str(tmp_path / "missing"))
    monkeypatch.setenv("DIFF_VITS_NO_COMPILE_CACHE", "1")
    for fe in (tfe, jfe):
        monkeypatch.setattr(fe, "_cmudict_cache", {})


def _args(files, out_dir, *extra):
    cfg, ckpt, wav = files
    return ["--text", TEXT, "--lang", "EN", "--refer", wav, "-c", cfg,
            "-m", ckpt, "--steps", "2", "--sample_method", "ddim",
            "--dtype", "float32", "--out_dir", str(out_dir), *extra]


def test_tts_infer_writes_the_frames_jax_writes(files, no_cmudict, tmp_path,
                                                monkeypatch):
    tts_infer.main(_args(files, tmp_path / "port", "--vocoder", "jax",
                         "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["tts_infer"] + _args(
        files, tmp_path / "jax", "--vocoder", "none"))
    jtts.main()
    mel = np.load(tmp_path / "port" / "tts_prompt.wav.mel.npy")
    ref = np.load(tmp_path / "jax" / "tts_prompt.wav.mel.npy")
    print(f"frames: port {mel.shape[0]}, jax {ref.shape[0]}")
    assert mel.shape == ref.shape and mel.shape[1] == 100
    assert mel.shape[0] > 1 and np.isfinite(mel).all()
    wav, sr = jaudio.read_wav(str(tmp_path / "port" / "tts_prompt.wav.wav"))
    assert sr == 24000 and len(wav) == (mel.shape[0] - 1) * 256
    assert not (tmp_path / "jax" / "tts_prompt.wav.wav").exists()


def test_tts_infer_mel_only_without_a_vocoder_checkpoint(files, no_cmudict,
                                                         tmp_path):
    tts_infer.main(_args(files, tmp_path, "--device", "cpu"))
    assert (tmp_path / "tts_prompt.wav.mel.npy").exists()
    assert not (tmp_path / "tts_prompt.wav.wav").exists()


def test_load_refer_mel_matches_jax(files, tmp_path):
    cfg_path, _, wav = files
    other = write_wav(tmp_path / "prompt16k.wav", 0.5, seed=2, sr=16000)
    for path in (wav, other):
        ours = tts_infer.load_refer_mel(path, load_config(cfg_path))
        theirs = jtts.load_refer_mel(path, load_config(cfg_path))
        assert ours.shape == theirs.shape and ours.dtype == np.float32
        assert ours.shape[0] == 1 and ours.shape[2] == 100
        err = float(np.abs(ours - np.asarray(theirs)).max())
        print(f"{path}: max |mel diff| = {err:.2e} (atol 2e-4)")
        np.testing.assert_allclose(ours, theirs, atol=2e-4)


def test_tts_infer_refuses_what_it_does_not_run(files, tmp_path,
                                                monkeypatch, capsys):
    with pytest.raises(SystemExit):
        tts_infer.main(_args(files, tmp_path, "--device", "cpu",
                             "--sample_method", "euler"))
    with pytest.raises(SystemExit):
        tts_infer.main(_args(files, tmp_path, "--vocoder", "torch",
                             "--device", "cpu"))
    assert "invalid choice" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tts_infer.main(_args(files, tmp_path))
