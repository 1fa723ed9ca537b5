"""The port's datasets and loaders against the JAX package's, on the same
files: ``parse_cleaned_line`` ids exactly, ``TextMelDataset.load`` on each
of its sources (a ``.mel.npy`` sidecar, the reference's ``.mel.pt``, a wav
alone, a filtered item), ``TrainLoader`` batches field by field across an
epoch boundary on both hosts of two, the empty-epoch error,
``NativeTrainLoader`` batches (the same C++ source, built by each package
into its own place) and ``TextAudioLegacyDataset``. Inputs are seeded with
numpy and written under ``tmp_path``."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from diff_vits_tpu.core import config as jconfig
from diff_vits_tpu.data import dataset as jdataset
from diff_vits_tpu.data import native_loader as jnative
from diff_vits_tpu_torch.core import config as tconfig
from diff_vits_tpu_torch.data import audio
from diff_vits_tpu_torch.data import dataset as tdataset
from diff_vits_tpu_torch.data import native_loader as tnative
from diff_vits_tpu_torch.text.symbols import symbols

torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(tdataset.Batch)]


def configs(**data):
    """(JAX Config, port Config) with the same train and data fields."""
    train = dict(train_batch_size=3, seed=11)
    data = dict(n_mel_channels=100, max_text_len=12, max_mel_len=60,
                min_mel_len=20, **data)
    return (jconfig.Config(train=jconfig.TrainConfig(**train),
                           data=jconfig.DataConfig(**data)),
            tconfig.Config(train=tconfig.TrainConfig(**train),
                           data=tconfig.DataConfig(**data)))


def cleaned_line(rng, n_phones, lang="EN"):
    phones = " ".join(symbols[int(j)] for j in rng.integers(1, 60, n_phones))
    tones = " ".join(str(int(t)) for t in rng.integers(0, 3, n_phones))
    return f"{lang}|text|{phones}|{tones}|{' '.join('1' * n_phones)}"


def write_corpus(root, n=9, seed=0, frames=(15, 130), sources=None):
    """``n`` utterances: a wav, a cleaned transcript and (by ``sources``,
    default all ``npy``) a ``.mel.npy`` sidecar, a ``.mel.pt`` or nothing
    (the mel of the wav). Frame counts in ``frames`` (some under the
    configs' min_mel_len of 20); one text over the 2 x 12 + 1 cap."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        base = os.path.join(root, f"spk{i % 2}", f"u{i}")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        t = int(rng.integers(*frames))
        wav = 0.2 * rng.normal(size=(t - 1) * 256).astype(np.float32)
        audio.write_wav(base + ".wav", wav, 24000)
        n_ph = 14 if i == 4 else int(rng.integers(2, 12))
        with open(base + ".txt", "w", encoding="utf-8") as f:
            f.write(cleaned_line(rng, n_ph) + "\n")
        mel = rng.normal(size=(t, 100)).astype(np.float32)
        kind = (sources or {}).get(i, "npy")
        if kind == "npy":
            np.save(base + ".mel.npy", mel)
        elif kind == "pt":
            torch.save(torch.from_numpy(mel.T[None].copy()), base + ".mel.pt")
    return root


def assert_batches_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("add_blank", [True, False])
@pytest.mark.parametrize("line", [
    "ZH|你好，世界。|_ n i h ao , sh ir j ie . _|0 3 3 3 3 0 4 4 4 4 0 0|"
    "1 2 2 1 2 2 1 1",
    "EN|hello world.|_ hh eh l ow w er l d . _|0 0 2 0 1 0 2 0 0 0 0|"
    "1 4 4 1 1",
    "JA|こんにちは|_ k o N n i ch i h a _|0 0 0 0 0 0 0 0 0 0 0|1 9 1"])
def test_parse_cleaned_line_ids_equal(line, add_blank):
    want = jdataset.parse_cleaned_line(line, add_blank)
    got = tdataset.parse_cleaned_line(line, add_blank)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    n = len(line.split("|")[2].split(" "))
    assert len(got[0]) == (2 * n + 1 if add_blank else n)


def test_text_mel_dataset_loads_each_source_as_jax(tmp_path):
    root = write_corpus(str(tmp_path), n=6, frames=(40, 90),
                        sources={1: "pt", 2: "wav", 5: "wav"})
    os.remove(os.path.join(root, "spk1", "u5.txt"))     # unreadable
    jcfg, tcfg = configs(training_files=root)
    jds, tds = jdataset.TextMelDataset(jcfg), tdataset.TextMelDataset(tcfg)
    assert tds.audiopaths == jds.audiopaths and len(tds) == 6
    loaded = {}
    for i in range(len(tds)):
        want, got = jds.load(i), tds.load(i)
        name = os.path.basename(tds.audiopaths[i])
        loaded[name] = got is not None
        assert (want is None) == (got is None), name
        if got is None:
            continue
        for f in ("phones", "tones", "languages", "mel"):
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == w.dtype, (name, f)
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {f}")
    # u4's 14 phones intersperse to 29 > 2 x 12 + 1; u5 has no transcript
    assert loaded == {"u0.wav": True, "u1.wav": True, "u2.wav": True,
                      "u3.wav": True, "u4.wav": False, "u5.wav": False}
    # the .mel.pt and the wav-only mel arrive as [T, 100]
    assert tds.load(tds.audiopaths.index(
        os.path.join(root, "spk1", "u1.wav"))).mel.shape[1] == 100


@pytest.mark.parametrize("host_id", [0, 1])
def test_train_loader_batches_equal_jax_on_each_host(tmp_path, host_id):
    root = write_corpus(str(tmp_path), n=14, sources={3: "pt", 6: "wav"})
    jcfg, tcfg = configs(training_files=root)
    kw = dict(batch_size=2, seed=5, host_id=host_id, num_hosts=2)
    jit = iter(jdataset.TrainLoader(jdataset.TextMelDataset(jcfg), jcfg,
                                    **kw))
    loader = tdataset.TrainLoader(tdataset.TextMelDataset(tcfg), tcfg, **kw)
    tit = iter(loader)
    # 7 items a host, some under min_mel_len or over the text cap: one
    # or two batches an epoch, so 3 batches cross into the next epoch
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert_batches_equal(want, got)
        assert got.text.shape == (2, 25) and got.spec.shape == (2, 60, 100)
        assert got.refer1.shape == got.refer2.shape == (2, 41, 100)


def test_train_loader_empty_epoch_raises_as_jax(tmp_path):
    root = write_corpus(str(tmp_path), n=4, frames=(5, 15))
    jcfg, tcfg = configs(training_files=root)
    with pytest.raises(ValueError) as want:
        next(iter(jdataset.TrainLoader(jdataset.TextMelDataset(jcfg), jcfg)))
    with pytest.raises(ValueError) as got:
        next(iter(tdataset.TrainLoader(tdataset.TextMelDataset(tcfg), tcfg)))
    assert str(got.value) == str(want.value)
    assert "epoch 0 produced no batches" in str(got.value)


@pytest.mark.parametrize("batch_size,host_id,num_hosts",
                         [(3, 0, 1), (2, 1, 2)])
def test_native_loader_batches_equal_jax(tmp_path, batch_size, host_id,
                                         num_hosts):
    if not (jnative.native_available() and tnative.native_available()):
        pytest.skip("g++ with OpenMP is not available")
    root = write_corpus(str(tmp_path), n=12, sources={2: "wav", 7: "pt"})
    jcfg, tcfg = configs(training_files=root)
    kw = dict(batch_size=batch_size, seed=9, host_id=host_id,
              num_hosts=num_hosts)
    jl = jnative.NativeTrainLoader(jdataset.TextMelDataset(jcfg), jcfg, **kw)
    tl = tnative.NativeTrainLoader(tdataset.TextMelDataset(tcfg), tcfg, **kw)
    assert len(tl) == len(jl) == 9          # sidecar items within the cap
    assert tnative.library_path().is_file()
    jit, tit = iter(jl), iter(tl)
    for _ in range(4):                      # across the epoch boundary
        assert_batches_equal(next(jit), next(tit))


@pytest.mark.parametrize("n,frames", [(2, (40, 130)), (4, (5, 15))])
def test_native_loader_empty_epoch_raises(tmp_path, n, frames):
    """Fewer sidecar items than a batch, or every crop under min_mel_len:
    the epoch yields nothing and the loader raises TrainLoader's error
    (JAX's native loader would start the next epoch forever)."""
    if not tnative.native_available():
        pytest.skip("g++ with OpenMP is not available")
    root = write_corpus(str(tmp_path), n=n, frames=frames)
    _, tcfg = configs(training_files=root)
    tl = tnative.NativeTrainLoader(tdataset.TextMelDataset(tcfg), tcfg)
    assert len(tl) == n                     # every item has its sidecar
    with pytest.raises(ValueError, match="epoch 0 produced no batches"):
        next(iter(tl))


def test_native_loader_library_named_by_its_source(tmp_path, monkeypatch):
    """The library's name carries a digest of the source and the flags, so
    a library built from another source is never loaded."""
    name = tnative.library_path().name
    assert name.startswith("libloader-") and name.endswith(".so")
    other = tmp_path / "loader.cc"
    other.write_bytes(tnative.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(tnative, "SOURCE", other)
    assert tnative.library_path().name != name


def test_native_loader_source_is_the_root_copy():
    root = tnative.SOURCE.parents[2] / "csrc" / "loader.cc"
    assert tnative.SOURCE.read_bytes() == root.read_bytes()


def test_legacy_dataset_loads_spec_and_wav_as_jax(tmp_path):
    root = write_corpus(str(tmp_path), n=3, frames=(40, 60))
    base = os.path.join(root, "spk0", "u0")
    np.save(base + ".spec.npy", np.random.default_rng(1).normal(
        size=(50, 513)).astype(np.float32))
    jcfg, tcfg = configs(training_files=root)
    jds = jdataset.TextAudioLegacyDataset(jcfg)
    tds = tdataset.TextAudioLegacyDataset(tcfg)
    for i in range(len(tds)):
        (wex, wspec, wwav), (gex, gspec, gwav) = jds.load(i), tds.load(i)
        np.testing.assert_array_equal(gex.mel, wex.mel)
        np.testing.assert_array_equal(gwav, wwav)
        assert (gspec is None) == (wspec is None) == (i != 0)
        if gspec is not None:
            np.testing.assert_array_equal(gspec, wspec)
