"""Training dataset: cleaned text and mel loading, static-shape batching.

Port of ``diff_vits_tpu/data/dataset.py`` (numpy on the host; batches go to
the device in ``train.trainer``):

* ``parse_cleaned_line``: a ``lang|norm|phones|tones|word2ph`` line to
  phone, tone and language ids, blank-interspersed;
* ``TextMelDataset``: the wavs under a folder, each with its ``.txt`` and
  its mel from the ``.mel.npy`` sidecar, else the reference repo's
  ``.mel.pt``, else the log-mel of the wav; items whose interspersed text
  is out of ``[min_text_len, 2 * max_text_len + 1]`` are filtered;
* ``TrainLoader``: epoch shuffle seeded ``seed * 1_000_003 + epoch``, the
  host shard ``order[host_id::num_hosts]``, ``random_slice`` per item and
  static [B, Tx | Ty | S] buffers (Tx = 2 max_text_len + 1, Ty =
  max_mel_len, S = max_mel_len * 2 // 3 + 1); an epoch that yields nothing
  raises;
* ``TextAudioLegacyDataset``: also the linear ``.spec.npy`` and the wav.

``random_slice``, ``pad_to`` and ``Batch`` live in ``data.batch``.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import Iterator, List, Optional

import numpy as np
import torch

from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.masking import intersperse
from diff_vits_tpu_torch.data import audio as audio_lib
from diff_vits_tpu_torch.data.batch import Batch, random_slice
from diff_vits_tpu_torch.text.frontend import cleaned_text_to_sequence


@dataclasses.dataclass
class Example:
    phones: np.ndarray      # [Tx] int32
    tones: np.ndarray       # [Tx] int32
    languages: np.ndarray   # [Tx] int32
    mel: np.ndarray         # [Ty, 100] float32
    wav: Optional[np.ndarray] = None


def parse_cleaned_line(line: str, add_blank: bool = True):
    """'lang|norm|phones|tones|word2ph' -> (phones, tones, languages)
    int32 arrays, blank-interspersed when ``add_blank``."""
    language, _text, phones_s, tones_s, _word2ph = line.strip().split("|")
    phones = phones_s.split(" ")
    tones = [int(i) for i in tones_s.split(" ")]
    phone, tone, lang = cleaned_text_to_sequence(phones, tones, language)
    if add_blank:
        phone = intersperse(phone, 0)
        tone = intersperse(tone, 0)
        lang = intersperse(lang, 0)
    return (np.asarray(phone, np.int32), np.asarray(tone, np.int32),
            np.asarray(lang, np.int32))


def text_buffer_len(cfg: Config) -> int:
    """Tx: the text length a batch holds (interspersed when add_blank)."""
    return cfg.data.max_text_len * 2 + 1 if cfg.data.add_blank \
        else cfg.data.max_text_len


class TextMelDataset:
    """(cleaned text, mel) pairs of the wavs under ``root`` (default
    ``data.training_files``), in sorted path order."""

    def __init__(self, cfg: Config, root: Optional[str] = None):
        self.cfg = cfg
        root = root or cfg.data.training_files
        self.audiopaths = sorted(
            glob.glob(os.path.join(root, "**", "*.wav"), recursive=True))
        self.hop_length = cfg.data.hop_length
        self.add_blank = cfg.data.add_blank

    def __len__(self):
        return len(self.audiopaths)

    def load(self, index: int) -> Optional[Example]:
        """The item at ``index``; None when unreadable or filtered."""
        path = self.audiopaths[index]
        txt_path = path[:-4] + ".txt"
        mel_path = path[:-4] + ".mel.npy"
        try:
            with open(txt_path, encoding="utf-8") as f:
                phones, tones, langs = parse_cleaned_line(
                    f.readline(), self.add_blank)
            if os.path.exists(mel_path):
                mel = np.load(mel_path)
            elif os.path.exists(path[:-4] + ".mel.pt"):
                # the reference repo's torch-saved [1, 100, T] log-mel
                t = torch.load(path[:-4] + ".mel.pt", map_location="cpu",
                               weights_only=True)
                mel = np.ascontiguousarray(
                    t.numpy().reshape(-1, t.shape[-1]).T)
            else:
                wav, sr = audio_lib.read_wav(path)
                wav = audio_lib.resample(wav, sr, self.cfg.data.sampling_rate)
                mel = audio_lib.log_mel(wav, sr=self.cfg.data.sampling_rate,
                                        hop_length=self.hop_length,
                                        n_mels=self.cfg.data.n_mel_channels)
        except (OSError, ValueError):
            return None
        # `phones` is interspersed already: the cap is the batch's text
        # buffer, as in the collate and the native loader
        if not (self.cfg.data.min_text_len <= len(phones)
                <= text_buffer_len(self.cfg)):
            return None
        return Example(phones, tones, langs, mel.astype(np.float32))


class TrainLoader:
    """Shuffled, per-host-sharded, static-shape batch iterator; each host
    takes ``order[host_id::num_hosts]`` of an epoch's shuffled order."""

    def __init__(self, dataset: TextMelDataset, cfg: Config,
                 batch_size: Optional[int] = None, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.train.train_batch_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.max_text = text_buffer_len(cfg)
        self.max_mel = cfg.data.max_mel_len

    def __iter__(self) -> Iterator[Batch]:
        epoch = 0
        while True:
            rng = random.Random(self.seed * 1_000_003 + epoch)
            order = list(range(len(self.ds)))
            rng.shuffle(order)
            order = order[self.host_id::self.num_hosts]
            buf: List = []
            n_yielded = 0
            for idx in order:
                ex = self.ds.load(idx)
                if ex is None:
                    continue
                sliced = random_slice(ex.mel, rng,
                                      max_frames=self.cfg.data.max_mel_len,
                                      min_frames=self.cfg.data.min_mel_len)
                if sliced is None:
                    continue
                buf.append((ex, sliced))
                if len(buf) == self.batch_size:
                    yield self._collate(buf)
                    buf = []
                    n_yielded += 1
            if n_yielded == 0:
                raise ValueError(
                    f"epoch {epoch} produced no batches: "
                    f"{len(order)} candidate utterances on host "
                    f"{self.host_id}/{self.num_hosts}, all filtered "
                    f"(< data.min_mel_len={self.cfg.data.min_mel_len} "
                    f"frames or unreadable), or fewer than batch_size="
                    f"{self.batch_size} survived")
            epoch += 1

    def _collate(self, items) -> Batch:
        t_x = self.max_text
        t_y = self.max_mel
        # prompt spans hold at most 2/3 of max_mel frames, + 1
        s_max = self.max_mel * 2 // 3 + 1
        b = len(items)
        c = items[0][0].mel.shape[-1]
        batch = Batch(
            text=np.zeros((b, t_x), np.int32),
            tone=np.zeros((b, t_x), np.int32),
            language=np.zeros((b, t_x), np.int32),
            spec=np.zeros((b, t_y, c), np.float32),
            refer1=np.zeros((b, s_max, c), np.float32),
            refer2=np.zeros((b, s_max, c), np.float32),
            text_lengths=np.zeros(b, np.int32),
            spec_lengths=np.zeros(b, np.int32),
            refer1_lengths=np.zeros(b, np.int32),
            refer2_lengths=np.zeros(b, np.int32),
        )
        for i, (ex, (spec, r1, r2)) in enumerate(items):
            n_t = min(len(ex.phones), t_x)
            batch.text[i, :n_t] = ex.phones[:n_t]
            batch.tone[i, :n_t] = ex.tones[:n_t]
            batch.language[i, :n_t] = ex.languages[:n_t]
            batch.text_lengths[i] = n_t
            n_y = min(spec.shape[0], t_y)
            batch.spec[i, :n_y] = spec[:n_y]
            batch.spec_lengths[i] = n_y
            n1 = min(r1.shape[0], s_max)
            batch.refer1[i, :n1] = r1[:n1]
            batch.refer1_lengths[i] = n1
            n2 = min(r2.shape[0], s_max)
            batch.refer2[i, :n2] = r2[:n2]
            batch.refer2_lengths[i] = n2
        return batch


class TextAudioLegacyDataset(TextMelDataset):
    """The non-split dataset of the model/model2 variants: ``load`` gives
    (Example, the 513-bin linear ``.spec.npy`` or None, the wav at
    ``data.sampling_rate``), no prompt split."""

    def load(self, index: int):
        ex = super().load(index)
        if ex is None:
            return None
        path = self.audiopaths[index]
        spec_path = path[:-4] + ".spec.npy"
        spec = np.load(spec_path) if os.path.exists(spec_path) else None
        wav, sr = audio_lib.read_wav(path)
        wav = audio_lib.resample(wav, sr, self.cfg.data.sampling_rate)
        return ex, spec, wav
