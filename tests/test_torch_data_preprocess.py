"""The port's offline preprocessing against the JAX package's on the same
files: ``process_one`` with and without ``--cleaned`` writes the same
transcript line and wav, and ``.mel.npy`` / ``.spec.npy`` within 1e-6
absolute; ``main`` processes a whole folder; ``aishell.prepare`` writes
the same files. Inputs are seeded with numpy and written under
``tmp_path``."""
import filecmp
import os

import numpy as np
import pytest

from diff_vits_tpu.data import aishell as jaishell
from diff_vits_tpu.data import preprocess as jpre
from diff_vits_tpu_torch.data import aishell as taishell
from diff_vits_tpu_torch.data import audio
from diff_vits_tpu_torch.data import preprocess as tpre

TEXTS = ["Hello world, this is a test.", "It was a bright cold day."]
CLEANED = "EN|hello|_ hh eh l ow _|0 0 2 0 1 0|1 4 1"


def write_inputs(root, sr=16000, seed=0):
    """Two 16 kHz wavs (resampled to 24 kHz by preprocessing): one with
    English text, one with a cleaned line; one in a subfolder."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    paths = []
    for i, (name, text) in enumerate([("a", TEXTS[0]),
                                      ("sub/b", CLEANED)]):
        t = np.arange(int(rng.uniform(0.4, 0.8) * sr)) / sr
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 300) * t) \
            + 0.02 * rng.normal(size=t.shape)
        path = os.path.join(root, name + ".wav")
        audio.write_wav(path, wav.astype(np.float32), sr)
        with open(path[:-4] + ".txt", "w", encoding="utf-8") as f:
            f.write(text + "\n")
        paths.append(path)
    return paths


def assert_outputs_equal(jout, tout, stem, spec=True):
    with open(os.path.join(jout, stem + ".txt"), encoding="utf-8") as f:
        want = f.read()
    with open(os.path.join(tout, stem + ".txt"), encoding="utf-8") as f:
        assert f.read() == want
    assert filecmp.cmp(os.path.join(jout, stem + ".wav"),
                       os.path.join(tout, stem + ".wav"), shallow=False)
    for ext in (".mel.npy", ".spec.npy") if spec else (".mel.npy",):
        w = np.load(os.path.join(jout, stem + ext))
        g = np.load(os.path.join(tout, stem + ext))
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert os.path.exists(os.path.join(tout, stem + ".spec.npy")) == spec


@pytest.mark.parametrize("cleaned", [False, True])
def test_process_one_writes_what_jax_writes(tmp_path, cleaned):
    src = str(tmp_path / "in")
    paths = write_inputs(src)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    for p in paths:
        jpre.process_one(p, "EN", src, jout, cleaned=cleaned)
        tpre.process_one(p, "EN", src, tout, cleaned=cleaned)
    for stem in ("a", "sub/b"):
        assert_outputs_equal(jout, tout, stem)
    with open(os.path.join(tout, "sub", "b.txt"), encoding="utf-8") as f:
        line = f.read().strip()
    # --cleaned passes the cleaned line through; without it the line is
    # taken as text and cleaned again
    assert (line == CLEANED) == cleaned
    with open(os.path.join(tout, "a.txt"), encoding="utf-8") as f:
        assert f.read().startswith("EN|Hello world, this is a test.|_ hh ")
    _, sr = audio.read_wav(os.path.join(tout, "a.wav"))
    assert sr == 24000


def test_main_processes_a_folder(tmp_path, monkeypatch):
    src = str(tmp_path / "in")
    write_inputs(src)
    tpre.main(["--in_dir", src, "--language", "EN", "--cleaned",
               "--no_spec"])
    jout = str(tmp_path / "jax")
    monkeypatch.setattr("sys.argv", ["preprocess", "--in_dir", src,
                                     "--language", "EN", "--cleaned",
                                     "--no_spec", "--out_dir", jout])
    jpre.main()
    for stem in ("a", "sub/b"):
        assert_outputs_equal(jout, src + "_processed", stem, spec=False)


def test_aishell_prepare_writes_what_jax_writes(tmp_path):
    src = tmp_path / "AISHELL3"
    wav_dir = src / "train" / "wav" / "SSB0005"
    wav_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for utt in ("SSB00050001", "SSB00050002", "SSB00050003"):
        audio.write_wav(str(wav_dir / f"{utt}.wav"),
                        0.1 * rng.normal(size=800).astype(np.float32), 44100)
    (src / "train" / "label_train-set.txt").write_text(
        "# AISHELL-3 labels\n\n"
        "SSB00050001|guang3 zhou1|广州女大学生\n"
        "SSB00050002|tai4 yang2|太阳\n"
        "SSB00059999|mei2|没有这个文件\n", encoding="utf-8")
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jaishell.prepare(str(src), jout)
    taishell.prepare(str(src), tout)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == [
        "SSB00050001.txt", "SSB00050001.wav", "SSB00050002.txt",
        "SSB00050002.wav"]
    for name in os.listdir(jout):
        assert filecmp.cmp(os.path.join(jout, name),
                           os.path.join(tout, name), shallow=False), name
    taishell.main(["--in_dir", str(src), "--out_dir", str(tmp_path / "m")])
    assert sorted(os.listdir(tmp_path / "m")) == sorted(os.listdir(tout))
