"""The one traffic generator: a mix's data file in, requests or training
batches out, the same for the same seed.

A mix is ``benchmark/traffic/<name>.json``. Its ``kind`` says what it
feeds: ``serve`` (offline jobs of synthesis requests) or ``train``
(loader-shaped training batches). Lengths come from a fixed grid of the
mix's distribution (the same multiset for every seed and every job); the
seed orders them and draws the ids and mels, so that seeds change what is
said and not how much.
"""
from __future__ import annotations

import json
import random
import statistics
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent

# (utt_id, phone ids [T], tone ids [T], language ids [T], prompt mel [S, C])
Request = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def load(name: str) -> Dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def grid(n: int, median: float, sigma: float, lo: int, hi: int) -> List[int]:
    """n values of a log-normal (``median``, log-sd ``sigma``) at the
    quantiles (i + 1/2) / n, rounded and cut to [lo, hi]."""
    normal = statistics.NormalDist()
    return [int(min(hi, max(lo, round(median * np.exp(
        sigma * normal.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *salt])


def text_ids(rng: np.random.Generator, syllables: int, phones_per: int,
             n_symbols: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Phone, tone and language ids of one sentence with blanks between
    phones and at both ends (``add_blank``): 2 * phones + 1 tokens."""
    n_ph = syllables * phones_per
    phone = np.zeros(2 * n_ph + 1, np.int64)
    tone = np.zeros(2 * n_ph + 1, np.int64)
    phone[1::2] = rng.integers(1, n_symbols, n_ph)
    tone[1::2] = np.repeat(rng.integers(1, 6, syllables), phones_per)
    language = np.full(2 * n_ph + 1, rng.integers(0, 3), np.int64)
    return phone, tone, language


def serve_jobs(mix: Dict, seed: int, n_symbols: int, n_mels: int,
               n_jobs: int) -> List[List[Request]]:
    """``n_jobs`` jobs of ``mix["job_requests"]`` requests. Every job says
    the same multiset of sentence lengths in its own order; each request
    takes one of the run's ``mix["speakers"]`` prompt mels."""
    syl = mix["syllables"]
    lengths = grid(mix["job_requests"], syl["median"], syl["sigma"],
                   syl["min"], syl["max"])
    prompts = _rng(seed, 0).standard_normal(
        (mix["speakers"], mix["prompt_frames"], n_mels)).astype(np.float32)
    jobs = []
    for j in range(n_jobs):
        rng = _rng(seed, 1, j)
        job = []
        for k, i in enumerate(rng.permutation(len(lengths))):
            ids = text_ids(rng, lengths[i], mix["phones_per_syllable"],
                           n_symbols)
            job.append((f"j{j}r{k}", *ids,
                        prompts[rng.integers(0, len(prompts))]))
        jobs.append(job)
    return jobs


def train_batches(mix: Dict, seed: int, n_symbols: int, n_mels: int,
                  n_batches: int) -> List:
    """``n_batches`` loader-shaped batches (``data.batch.Batch`` fields as
    a dict of arrays): every batch holds the same multiset of utterance
    lengths (``mix["frames"]`` of the crop, 0.3 to 2 crops, a fixed grid)
    in its own order; each utterance is cut to the crop and split into
    its target and two prompts as the loader splits it; text lengths are
    ``mix["frames_per_token"]`` of the frames kept, within the buffer."""
    b, t_x, t_y = mix["batch_size"], mix["text_buffer"], mix["mel_crop"]
    s_max = mix["prompt_frames"]
    f = mix["frames"]
    n_frames = grid(b, f["median"], f["sigma"], f["min"], f["max"])
    batches = []
    for k in range(n_batches):
        rng = _rng(seed, 2, k)
        py_rng = random.Random(int(rng.integers(0, 2 ** 31)))
        order = rng.permutation(b)
        cut = []
        for i in order:
            n = n_frames[i]
            mel = rng.standard_normal((n, n_mels)).astype(np.float32)
            if n > t_y:
                s = py_rng.randint(0, n - t_y)
                mel = mel[s:s + t_y]
            m = mel.shape[0]
            span = py_rng.randint(m // 3, m // 3 * 2)
            u = py_rng.randint(0, m - span)
            cut.append((mel, mel[u:u + span],
                        np.concatenate([mel[:u], mel[u + span:]], axis=0)))
        spec_len = np.array([len(c[0]) for c in cut])
        text_len = np.minimum(
            t_x, np.ceil(spec_len / mix["frames_per_token"])).astype(np.int64)
        keep = np.arange(t_x)[None] < text_len[:, None]

        def ids(lo, hi):
            return rng.integers(lo, hi, (b, t_x)) * keep

        def mels(i, n):
            out = np.zeros((b, n, n_mels), np.float32)
            for r, c in enumerate(cut):
                out[r, :min(n, len(c[i]))] = c[i][:n]
            return out

        batches.append(dict(
            text=ids(1, n_symbols), tone=ids(0, 11), language=ids(0, 3),
            spec=mels(0, t_y), refer1=mels(1, s_max), refer2=mels(2, s_max),
            text_lengths=text_len, spec_lengths=spec_len,
            refer1_lengths=np.array([min(s_max, len(c[1])) for c in cut]),
            refer2_lengths=np.array([min(s_max, len(c[2])) for c in cut])))
    return batches


def audio_seconds(frames: Sequence[int], hop: int, rate: int) -> float:
    return float(sum(frames)) * hop / rate
