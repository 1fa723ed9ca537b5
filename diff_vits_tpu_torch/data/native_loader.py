"""Native (C++/OpenMP) batch loader, a drop-in for ``TrainLoader``.

Port of ``diff_vits_tpu/data/native_loader.py``. The per-step feature path
(read each ``.mel.npy``, random crop, prompt-span split, zero-pad collate)
runs in one call of ``csrc/loader.cc`` (OpenMP over the items) through
ctypes, which releases the interpreter lock for the call; Python keeps the
epoch shuffle, the host shard and the text ids, parsed once.

The library is built with ``g++ -O3 -fopenmp -shared -fPIC`` into
``build/host/libloader-<digest>.so`` of the checkout (of an installed
package: the per-user cache beside the kernels' build). The digest covers
the source and the flags, as the kernels' build names do, so a changed
source is built anew and a library built from another source is never
loaded. It is written under a temporary name and renamed into place, so a
process never loads a half-written library while another builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import random
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.data.batch import Batch
from diff_vits_tpu_torch.data.dataset import (
    TextMelDataset, parse_cleaned_line, text_buffer_len)
from diff_vits_tpu_torch.ops import _cuda

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "loader.cc"
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return (_cuda.build_dir().parent / "host"
            / f"libloader-{h.hexdigest()[:12]}.so")


def _build_and_load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not so_path.exists():
            so_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.dvt_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            f32p, i32p, f32p, i32p, f32p, i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.dvt_load_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _build_and_load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeTrainLoader:
    """``TrainLoader``'s iteration (epoch reshuffle, disjoint host shards,
    static buffers) over the items that have a ``.mel.npy`` sidecar; the
    crops and prompt spans come from the native splitmix64 stream, seeded
    per batch by ``(seed << 20) ^ (epoch << 8) ^ pos``."""

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
        self.s_max = self.max_mel * 2 // 3 + 1
        self.lib = _build_and_load()

        # text sidecars parsed once; items without a mel sidecar dropped
        self.mel_paths: List[bytes] = []
        self.texts: List[np.ndarray] = []
        self.tones: List[np.ndarray] = []
        self.langs: List[np.ndarray] = []
        for path in dataset.audiopaths:
            txt_path = path[:-4] + ".txt"
            mel_path = path[:-4] + ".mel.npy"
            if not (os.path.exists(txt_path) and os.path.exists(mel_path)):
                continue
            try:
                with open(txt_path, encoding="utf-8") as f:
                    ph, tn, lg = parse_cleaned_line(f.readline(),
                                                    cfg.data.add_blank)
            except (OSError, ValueError):
                continue
            if not (cfg.data.min_text_len <= len(ph) <= self.max_text):
                continue
            self.mel_paths.append(mel_path.encode())
            self.texts.append(ph)
            self.tones.append(tn)
            self.langs.append(lg)

    def __len__(self):
        return len(self.mel_paths)

    def _load_native(self, idxs: List[int], seed: int):
        n = len(idxs)
        c = self.cfg.data.n_mel_channels
        spec = np.empty((n, self.max_mel, c), np.float32)
        r1 = np.empty((n, self.s_max, c), np.float32)
        r2 = np.empty((n, self.s_max, c), np.float32)
        sl = np.empty(n, np.int32)
        l1 = np.empty(n, np.int32)
        l2 = np.empty(n, np.int32)
        paths = (ctypes.c_char_p * n)(*[self.mel_paths[i] for i in idxs])
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self.lib.dvt_load_batch(
            paths, n, self.cfg.data.min_mel_len, self.max_mel,
            np.uint64(seed & (2**64 - 1)),
            spec.ctypes.data_as(f32p), sl.ctypes.data_as(i32p),
            r1.ctypes.data_as(f32p), l1.ctypes.data_as(i32p),
            r2.ctypes.data_as(f32p), l2.ctypes.data_as(i32p),
            self.max_mel, self.s_max, c)
        return spec, sl, r1, l1, r2, l2

    def __iter__(self) -> Iterator[Batch]:
        epoch = 0
        b = self.batch_size
        while True:
            rng = random.Random(self.seed * 1_000_003 + epoch)
            order = list(range(len(self.mel_paths)))
            rng.shuffle(order)
            order = order[self.host_id::self.num_hosts]
            pos = 0
            pending: List[int] = []
            n_yielded = 0
            while True:
                while len(pending) < b and pos < len(order):
                    pending.append(order[pos])
                    pos += 1
                if len(pending) < b:
                    break  # epoch exhausted
                seed = (self.seed << 20) ^ (epoch << 8) ^ pos
                spec, sl, r1, l1, r2, l2 = self._load_native(pending, seed)
                keep = np.nonzero(sl > 0)[0]
                batch_idx = [pending[k] for k in keep[:b]]
                if len(batch_idx) < b:
                    pending = [pending[k] for k in keep]  # refill and retry
                    if pos >= len(order):
                        break
                    continue
                yield self._assemble(batch_idx, spec[keep[:b]], sl[keep[:b]],
                                     r1[keep[:b]], l1[keep[:b]],
                                     r2[keep[:b]], l2[keep[:b]])
                pending = []
                n_yielded += 1
            if n_yielded == 0:
                raise ValueError(
                    f"epoch {epoch} produced no batches: "
                    f"{len(order)} candidate utterances with a .mel.npy "
                    f"sidecar on host {self.host_id}/{self.num_hosts}, all "
                    f"filtered (< data.min_mel_len={self.cfg.data.min_mel_len}"
                    f" frames or unreadable), or fewer than batch_size="
                    f"{b} survived")
            epoch += 1

    def _assemble(self, idxs, spec, sl, r1, l1, r2, l2) -> Batch:
        n = len(idxs)
        text = np.zeros((n, self.max_text), np.int32)
        tone = np.zeros((n, self.max_text), np.int32)
        lang = np.zeros((n, self.max_text), np.int32)
        tlen = np.zeros(n, np.int32)
        for j, i in enumerate(idxs):
            t = min(len(self.texts[i]), self.max_text)
            text[j, :t] = self.texts[i][:t]
            tone[j, :t] = self.tones[i][:t]
            lang[j, :t] = self.langs[i][:t]
            tlen[j] = t
        return Batch(text=text, tone=tone, language=lang,
                     spec=np.ascontiguousarray(spec),
                     refer1=np.ascontiguousarray(r1),
                     refer2=np.ascontiguousarray(r2),
                     text_lengths=tlen, spec_lengths=sl.astype(np.int32),
                     refer1_lengths=l1.astype(np.int32),
                     refer2_lengths=l2.astype(np.int32))
