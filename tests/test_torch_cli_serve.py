"""The port's ``serve`` command line on the CPU (``--device cpu``) at the
tiny config: a manifest of English rows {utt_id, text, lang, refer} (two
rows sharing one prompt wav), a checkpoint the JAX package wrote, batch 2,
two mel buckets: every row gets its ``.mel.npy`` and, with
``--vocoder_ckpt`` (a JAX vocoder ``.ckpt``), its ``.wav``, the duration
pass placing the rows in both buckets; each mel has the frame count the
JAX package's ``serve`` writes for the same manifest and checkpoint (two
rows in one mel bucket there: JAX compiles a program for each bucket,
~25 s each on a CPU). ``read_manifest`` equals JAX's and refuses a
malformed line; ``--dp`` without a process group runs as one rank and
writes what the run without it writes; unknown samplers are refused."""
import os
import sys

import numpy as np
import pytest
import torch

from diff_vits_tpu.data import audio as jaudio
from diff_vits_tpu.infer import serve as jserve
from diff_vits_tpu.models import vocoder as jvoc
from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu_torch.infer import serve
from test_torch_cli import files, no_cmudict, write_wav  # noqa: F401
from test_torch_vocoder import _published_state_dict

torch.set_num_threads(2)

ROWS = [("short", "Hi there."),
        ("long", "Hello world, this is a longer test of twelve words or so."),
        ("mid", "Testing the server, one two.")]
MEL_BUCKETS = "64,160"


def write_manifest(path, rows, files, tmp_path):
    _, _, wav = files
    other = write_wav(tmp_path / "other.wav", 0.4, seed=5)
    refers = [wav, other, wav]
    path.write_text("# utt_id\ttext\tlang\trefer\n\n" + "".join(
        f"{u}\t{t}\tEN\t{r}\n" for (u, t), r in zip(rows, refers)),
        encoding="utf-8")
    return str(path)


@pytest.fixture
def manifest(files, tmp_path):
    return write_manifest(tmp_path / "utts.tsv", ROWS, files, tmp_path)


def _args(files, manifest, out_dir, *extra, buckets=MEL_BUCKETS):
    cfg, ckpt, _ = files
    return ["--manifest", manifest, "-c", cfg, "-m", ckpt, "--batch_size",
            "2", "--steps", "2", "--sample_method", "ddim", "--dtype",
            "float32", "--mel_buckets", buckets, "--out_dir",
            str(out_dir), *extra]


def test_serve_writes_the_frames_jax_writes(files, no_cmudict, tmp_path,
                                            monkeypatch):
    rows = [ROWS[0], ROWS[2]]
    manifest = write_manifest(tmp_path / "two.tsv", rows, files, tmp_path)
    serve.main(_args(files, manifest, tmp_path / "port", "--device", "cpu",
                     buckets="128"))
    monkeypatch.setattr(sys, "argv", ["serve"] + _args(
        files, manifest, tmp_path / "jax", buckets="128"))
    jserve.main()
    frames = {}
    for utt, _ in rows:
        mel = np.load(tmp_path / "port" / f"{utt}.mel.npy")
        ref = np.load(tmp_path / "jax" / f"{utt}.mel.npy")
        assert mel.shape == ref.shape and mel.shape[1] == 100
        assert np.isfinite(mel).all()
        frames[utt] = mel.shape[0]
    print(f"frames {frames}, mel bucket 128")
    assert 1 < min(frames.values()) and max(frames.values()) <= 128


def test_serve_writes_wavs_with_a_vocoder_checkpoint(files, manifest,
                                                     no_cmudict, tmp_path):
    params = jvoc.convert_torch_vocos(_published_state_dict(512, 1536, 8,
                                                           seed=2))
    voc = jckpt.save_checkpoint(str(tmp_path / "voc"), 1,
                                {"params": params}, keep=0)
    serve.main(_args(files, manifest, tmp_path, "--device", "cpu",
                     "--vocoder_ckpt", voc))
    frames = []
    for utt, _ in ROWS:
        mel = np.load(tmp_path / f"{utt}.mel.npy")
        wav, sr = jaudio.read_wav(str(tmp_path / f"{utt}.wav"))
        n = mel.shape[0]
        assert mel.shape[1] == 100 and np.isfinite(mel).all()
        assert sr == 24000 and len(wav) in (n * 256, (n - 1) * 256)
        frames.append(n)
    print(f"frames {frames}, mel buckets {MEL_BUCKETS}")
    buckets = [int(b) for b in MEL_BUCKETS.split(",")]
    assert {min(b for b in buckets if b >= n) for n in frames} \
        == set(buckets)


def test_read_manifest_matches_jax(manifest, tmp_path):
    assert serve.read_manifest(manifest) == jserve.read_manifest(manifest)
    assert [r["utt_id"] for r in serve.read_manifest(manifest)] == [
        u for u, _ in ROWS]
    bad = tmp_path / "bad.tsv"
    bad.write_text("a\tb\tEN\n", encoding="utf-8")
    with pytest.raises(ValueError, match="4 tab-separated"):
        serve.read_manifest(str(bad))


def test_serve_refuses_dp_and_unknown_samplers(files, manifest, tmp_path,
                                              no_cmudict, capsys):
    serve.main(_args(files, manifest, tmp_path / "dp", "--device", "cpu",
                     "--dp"))
    assert "serve --dp: 1 data-parallel rank(s) (no process group" \
        in capsys.readouterr().out
    serve.main(_args(files, manifest, tmp_path / "one", "--device", "cpu"))
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "dp")) and names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "dp" / name),
                                      np.load(tmp_path / "one" / name))
    with pytest.raises(SystemExit):
        serve.main(_args(files, manifest, tmp_path, "--device", "cpu",
                         "--sample_method", "euler"))
