"""Batched serving: tokenised requests -> bucketed batches -> mel.

Port of ``BatchSynthesizer`` of ``diff_vits_tpu/infer/serve.py`` on
already-tokenised requests ``(utt_id, phone ids, tone ids, language ids,
refer mel [S, 100])``:

* requests group into text-length buckets; every batch is padded to
  [batch_size, T_bucket], short batches with repeats of their last row
  whose outputs are dropped;
* prompts are cropped or zero-padded to one frame count;
* a duration-only pass predicts each utterance's frame count and places it
  in the smallest mel bucket that holds it (clamped to the largest); the
  stochastic duration predictor draws there from a seeded generator other
  than the synthesis's, so its count gets 10% headroom;
* each (text bucket, mel bucket) batch is one ``synthesize`` call;
* results come back in request order, trimmed to their frame counts;
* with a vocoder (``models.vocoder.Vocos``), each bucket batch's mel is
  decoded whole, at its static shape, in float32, and each utterance's
  waveform trimmed to its frame count times the hop.

Weights are held in bfloat16 by default, as the JAX server casts them;
the vocoder stays in float32, as the JAX server keeps it. The text
frontend, reading prompts from wav files and the command line are the
next slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols

# (utt_id, phone ids [T], tone ids [T], language ids [T], refer mel [S, 100])
Request = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {max(buckets)}")


def pad_to(a: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n - a.shape[axis])
    return np.pad(a, pad)


class BatchSynthesizer:
    """Holds one model and synthesizes request lists in bucketed batches.

    ``state_dict`` is a port ``DiffVits`` state dict (for instance from
    ``utils.convert.from_flax_params``); the model is built on ``device``
    (the card unless given) in ``dtype``. ``vocoder`` (a
    ``models.vocoder.Vocos``, e.g. from ``load_vocoder``) is moved to that
    device in float32 and set to eval mode; with it ``synthesize_all``
    also returns waveforms.
    """

    def __init__(self, cfg: Config, state_dict, *, batch_size: int = 8,
                 steps: int = 30, sample_method: str = "unipc",
                 noise_scale: float = 0.667, length_scale: float = 1.0,
                 text_buckets: Optional[Sequence[int]] = None,
                 refer_frames: Optional[int] = None,
                 max_len: Optional[int] = None,
                 mel_buckets: Optional[Sequence[int]] = None,
                 vocoder: Optional[nn.Module] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.steps, self.sample_method = steps, sample_method
        self.noise_scale, self.length_scale = noise_scale, length_scale
        self.model = DiffVits(cfg, len(symbols), device=self.device,
                              dtype=dtype)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        t_max = cfg.data.max_text_len * (2 if cfg.data.add_blank else 1) + 1
        self.text_buckets = tuple(text_buckets) if text_buckets else tuple(
            b for b in (64, 128, 256, t_max) if b <= t_max) or (t_max,)
        self.refer_frames = refer_frames or cfg.data.max_mel_len * 2 // 3 + 1
        m = cfg.data.max_mel_len
        if max_len is not None:
            self.mel_buckets = (max_len,)
        else:
            self.mel_buckets = tuple(sorted(mel_buckets)) if mel_buckets \
                else (m, 2 * m, 4 * m)
        self.vocoder = None if vocoder is None else vocoder.to(
            self.device, torch.float32).eval()

    def pad_batch(self, requests: Sequence[Request], t_bucket: int):
        """``synthesize``'s six inputs for up to ``batch_size`` requests:
        texts padded to ``t_bucket``, prompts cut or zero-padded to
        ``refer_frames``, the batch filled with repeats of its last
        request; tensors on the model's device."""
        full = list(requests) + [requests[-1]] * (self.batch_size
                                                  - len(requests))
        s = self.refer_frames

        def refer(mel):
            mel = np.asarray(mel, np.float32)
            return mel[:s] if mel.shape[0] >= s else pad_to(mel, s)

        def ids(k):
            return np.stack([pad_to(np.asarray(r[k]), t_bucket)
                             for r in full]).astype(np.int64)

        arrays = (ids(1), np.array([len(r[1]) for r in full], np.int64),
                  np.stack([refer(r[4]) for r in full]),
                  np.full(self.batch_size, s, np.int64), ids(2), ids(3))
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    @torch.inference_mode()
    def _predict_mel_buckets(self, by_text, seed: int) -> Dict[int, int]:
        """Duration pass per text-bucket batch: request index -> mel
        bucket. Skipped with one mel bucket."""
        if len(self.mel_buckets) == 1:
            return {}
        assign: Dict[int, int] = {}
        top = self.mel_buckets[-1]
        # the stochastic predictor draws again inside synthesize, so the
        # realised count can exceed this one (the unet and conv predictors
        # are deterministic)
        headroom = 1.1 if self.cfg.vits.duration_predictor == "sdp" else 1.0
        for t_bucket, group in sorted(by_text.items()):
            for off in range(0, len(group), self.batch_size):
                chunk = group[off:off + self.batch_size]
                gen = torch.Generator().manual_seed(
                    seed * 2 ** 31 + t_bucket + off)
                lens = self.model.vits.predict_lengths(
                    *self.pad_batch([r for _, r in chunk], t_bucket),
                    length_scale=self.length_scale,
                    generator=gen).float().cpu().numpy()
                for j, (i, r) in enumerate(chunk):
                    n = int(np.ceil(headroom * lens[j]))
                    if n > top:
                        print(f"warning: {r[0]} predicted {n} frames > "
                              f"largest mel bucket {top}; clamping",
                              flush=True)
                    assign[i] = pick_bucket(min(n, top), self.mel_buckets)
        return assign

    def synthesize_all(self, requests: Sequence[Request], *, seed: int = 0
                       ) -> List[Tuple]:
        """[(utt_id, mel [T, n_mels] float32)] in request order, or
        [(utt_id, mel, wav [T * hop] float32)] with a vocoder."""
        by_text: Dict[int, list] = {}
        for i, r in enumerate(requests):
            by_text.setdefault(pick_bucket(len(r[1]), self.text_buckets),
                               []).append((i, r))
        mel_assign = self._predict_mel_buckets(by_text, seed)
        by_shape: Dict[Tuple[int, int], list] = {}
        for t_bucket, group in by_text.items():
            for i, r in group:
                m_bucket = mel_assign.get(i, self.mel_buckets[0])
                by_shape.setdefault((t_bucket, m_bucket), []).append((i, r))

        out: List[Optional[Tuple]] = [None] * len(requests)
        hop = self.cfg.data.hop_length
        for (t_bucket, m_bucket), group in sorted(by_shape.items()):
            for off in range(0, len(group), self.batch_size):
                chunk = group[off:off + self.batch_size]
                fold = ((t_bucket * 131 + m_bucket) * 100003 + off) % 2 ** 31
                gen = torch.Generator().manual_seed(seed * 2 ** 31 + fold)
                mel, out_lengths = synthesize(
                    self.model, *self.pad_batch([r for _, r in chunk],
                                                t_bucket),
                    generator=gen, sampling_steps=self.steps,
                    sample_method=self.sample_method,
                    noise_scale=self.noise_scale,
                    length_scale=self.length_scale, max_len=m_bucket,
                    device=self.device)
                wav = None
                if self.vocoder is not None:
                    # the whole bucket batch at its static shape
                    with torch.inference_mode():
                        wav = self.vocoder(mel.float()).cpu().numpy()
                mel = mel.float().cpu().numpy()
                lens = out_lengths.cpu().numpy()
                for j, (i, r) in enumerate(chunk):
                    n = int(lens[j])
                    out[i] = (r[0], mel[j, :n]) if wav is None else (
                        r[0], mel[j, :n], wav[j, :min(n * hop, wav.shape[1])])
        return [o for o in out if o is not None]
