"""Batched serving: manifest rows or tokenised requests -> bucketed
batches -> mel (-> wav).

Port of ``BatchSynthesizer``, ``read_manifest`` and the CLI of
``diff_vits_tpu/infer/serve.py``. ``synthesize_all`` takes manifest rows
``{utt_id, text, lang, refer}`` (the text through the frontend, each
prompt wav read once and its mel reused by every row that names it) or
already-tokenised requests ``(utt_id, phone ids, tone ids, language ids,
refer mel [S, 100])``:

* requests group into text-length buckets; every batch is padded to
  [batch_size, T_bucket], short batches with repeats of their last row
  whose outputs are dropped;
* prompts are cropped or zero-padded to one frame count;
* a duration-only pass predicts each utterance's frame count and places it
  in the smallest mel bucket that holds it (clamped to the largest); the
  stochastic duration predictor draws there from a seeded generator other
  than the synthesis's, so its count gets 10% headroom, and an utterance
  whose drawn count still fills a bucket below the largest is reported
  (its mel is cut to the bucket);
* each (text bucket, mel bucket) batch is one ``synthesize`` call;
* results come back in request order, trimmed to their frame counts;
* with a vocoder (``models.vocoder.Vocos``), each bucket batch's mel is
  decoded whole, at its static shape, in float32, and each utterance's
  waveform trimmed to its frame count times the hop.

Weights are held in bfloat16 by default, as the JAX server casts them;
the vocoder stays in float32, as the JAX server keeps it.

Data parallelism (``dp=True``, ``--dp``; JAX serve.py:109-125, :184,
:326-340): under ``torchrun`` every rank holds the model and synthesizes
its rows of every bucket batch (``batch_size`` must divide by the number
of ranks). Each rank draws the whole batch's noise from the batch's seeded
generator and keeps its rows (``parallel.mesh.global_batch_draws``), so
the mels are those of one process; the duration pass's counts and the
results are all-gathered, and rank 0 writes the files in manifest order.
Without a process group ``--dp`` is one rank, as JAX's mesh over one
device is.

Manifest: one utterance per line, tab-separated:
    utt_id <TAB> text <TAB> language(ZH|EN|JA) <TAB> refer_wav_path

Usage:
  python -m diff_vits_tpu_torch.infer.serve --manifest utts.tsv \
      -c config.json -m logs/tts/<run>/model-<step>.ckpt --batch_size 8 \
      [--mel_buckets 400,800,1600] [--vocoder_ckpt vocos.bin] \
      [--trace_out spans.json]
  torchrun --nproc_per_node N -m diff_vits_tpu_torch.infer.serve --dp \
      --manifest utts.tsv -c config.json -m model.ckpt --batch_size 8
"""
from __future__ import annotations

import argparse
import functools
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from diff_vits_tpu_torch.core import trace
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.data import audio as audio_lib
from diff_vits_tpu_torch.infer.tts_infer import (
    DTYPES, load_cli_config, load_refer_mel, preprocess_text)
from diff_vits_tpu_torch.models.diff_vits import (
    SAMPLE_METHODS, DiffVits, synthesize)
from diff_vits_tpu_torch.models.vocoder import load_vocoder
from diff_vits_tpu_torch.parallel import mesh as mesh_lib
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train.checkpoint import load_model_state_dict

# (utt_id, phone ids [T], tone ids [T], language ids [T], refer mel [S, 100])
Request = Tuple[str, np.ndarray, np.ndarray, np.ndarray, np.ndarray]
# {"utt_id", "text", "lang", "refer"}: a line of the manifest
Row = Mapping[str, str]


def read_manifest(path: str) -> List[Dict[str, str]]:
    """The rows of a tab-separated manifest (blank and # lines skipped)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 4:
                raise ValueError(
                    f"{path}:{ln}: expected 4 tab-separated fields "
                    f"(id, text, lang, refer), got {len(parts)}")
            rows.append(dict(zip(("utt_id", "text", "lang", "refer"), parts)))
    return rows


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
    also returns waveforms. ``dp``: each rank of the process group
    synthesizes its rows of every batch (see the module's docstring).
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
                 device: DeviceLike = None, dp: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.dp = dp
        self.world = mesh_lib.world_size() if dp else 1
        self.rank = mesh_lib.rank() if dp else 0
        # raises unless the ranks share batch_size equally
        mesh_lib.rows(batch_size, self.rank, self.world)
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

        with trace.span("dvt.front.pad"):
            arrays = (ids(1), np.array([len(r[1]) for r in full], np.int64),
                      np.stack([refer(r[4]) for r in full]),
                      np.full(self.batch_size, s, np.int64), ids(2), ids(3))
            return [torch.from_numpy(a).to(self.device) for a in arrays]

    @property
    def rows(self) -> slice:
        """This rank's rows of a batch of ``batch_size``."""
        return mesh_lib.rows(self.batch_size, self.rank, self.world)

    def _run_rows(self, fn, requests, t_bucket, gen, **kwargs):
        """``fn(model inputs, generator=gen, **kwargs)`` on this rank's rows
        of the padded batch of ``requests``, drawing the whole batch's
        noise from ``gen`` (one rank: the whole batch)."""
        inputs = [a[self.rows] for a in self.pad_batch(requests, t_bucket)]
        if self.world == 1:
            return fn(*inputs, generator=gen, **kwargs)
        with mesh_lib.global_batch_draws(gen, self.rows, self.batch_size):
            return fn(*inputs, generator=gen, **kwargs)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a batch (``dp``), in rank order."""
        return mesh_lib.all_gather_rows(t) if self.dp else t

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
        with trace.span("dvt.front.duration_pass"):
            for t_bucket, group in sorted(by_text.items()):
                for off in range(0, len(group), self.batch_size):
                    chunk = group[off:off + self.batch_size]
                    gen = torch.Generator().manual_seed(
                        seed * 2 ** 31 + t_bucket + off)
                    lens = self._gather(self._run_rows(
                        self.model.vits.predict_lengths,
                        [r for _, r in chunk], t_bucket, gen,
                        length_scale=self.length_scale)).float().cpu().numpy()
                    for j, (i, r) in enumerate(chunk):
                        n = int(np.ceil(headroom * lens[j]))
                        if n > top:
                            print(f"warning: {r[0]} predicted {n} frames > "
                                  f"largest mel bucket {top}; clamping",
                                  flush=True)
                        assign[i] = pick_bucket(min(n, top),
                                                self.mel_buckets)
        return assign

    def _prep_text(self, text: str, lang: str):
        """Phone, tone and language ids [T] of one text."""
        phone, tone, language = preprocess_text(text, lang,
                                                self.cfg.data.add_blank)
        return phone[0], tone[0], language[0]

    def _prep_refer(self, path: str) -> np.ndarray:
        """The prompt mel [S, n_mels] of one wav (``pad_batch`` cuts or
        pads it to ``refer_frames``)."""
        return load_refer_mel(path, self.cfg)[0]

    def _tokenise(self, rows: Sequence[Union[Row, Request]]
                  ) -> List[Request]:
        """Manifest rows as requests (each wav read once); requests as
        they are."""
        mels: Dict[str, np.ndarray] = {}
        out = []
        for r in rows:
            if not isinstance(r, Mapping):
                out.append(r)
                continue
            if r["refer"] not in mels:
                mels[r["refer"]] = self._prep_refer(r["refer"])
            out.append((r["utt_id"], *self._prep_text(r["text"], r["lang"]),
                        mels[r["refer"]]))
        return out

    def synthesize_all(self, requests: Sequence[Union[Row, Request]], *,
                       seed: int = 0) -> List[Tuple]:
        """[(utt_id, mel [T, n_mels] float32)] in request order, or
        [(utt_id, mel, wav [T * hop] float32)] with a vocoder. A request
        is a manifest row or a tokenised ``Request``. One ``dvt.job`` span
        of the port's tracer (``core.trace``)."""
        with trace.span("dvt.job", requests=len(requests)):
            return self._synthesize_all(requests, seed)

    def _synthesize_all(self, requests, seed: int) -> List[Tuple]:
        with trace.span("dvt.front.tokenise"):
            requests = self._tokenise(requests)
        with trace.span("dvt.front.bucket"):
            by_text: Dict[int, list] = {}
            for i, r in enumerate(requests):
                by_text.setdefault(pick_bucket(len(r[1]), self.text_buckets),
                                   []).append((i, r))
        mel_assign = self._predict_mel_buckets(by_text, seed)
        with trace.span("dvt.front.bucket"):
            by_shape: Dict[Tuple[int, int], list] = {}
            for t_bucket, group in by_text.items():
                for i, r in group:
                    m_bucket = mel_assign.get(i, self.mel_buckets[0])
                    by_shape.setdefault((t_bucket, m_bucket), []).append(
                        (i, r))

        out: List[Optional[Tuple]] = [None] * len(requests)
        hop = self.cfg.data.hop_length
        # the stochastic predictor draws again inside synthesize, past the
        # duration pass's headroom at times: a count that fills a bucket
        # below the largest was cut to it
        sdp = self.cfg.vits.duration_predictor == "sdp"
        for (t_bucket, m_bucket), group in sorted(by_shape.items()):
            for off in range(0, len(group), self.batch_size):
                chunk = group[off:off + self.batch_size]
                fold = ((t_bucket * 131 + m_bucket) * 100003 + off) % 2 ** 31
                gen = torch.Generator().manual_seed(seed * 2 ** 31 + fold)
                mel, out_lengths = self._run_rows(
                    functools.partial(synthesize, self.model),
                    [r for _, r in chunk], t_bucket, gen,
                    sampling_steps=self.steps,
                    sample_method=self.sample_method,
                    noise_scale=self.noise_scale,
                    length_scale=self.length_scale, max_len=m_bucket,
                    device=self.device)
                wav = None
                if self.vocoder is not None:
                    # the whole bucket batch at its static shape
                    with trace.span("dvt.vocoder"), torch.inference_mode():
                        wav = self.vocoder(mel.float())
                with trace.span("dvt.front.gather"):
                    if wav is not None:
                        wav = self._gather(wav).cpu().numpy()
                    mel = self._gather(mel.float()).cpu().numpy()
                    lens = self._gather(out_lengths).cpu().numpy()
                    for j, (i, r) in enumerate(chunk):
                        n = int(lens[j])
                        if sdp and n >= m_bucket and m_bucket != \
                                self.mel_buckets[-1]:
                            print(f"warning: {r[0]} filled its mel bucket "
                                  f"{m_bucket} (the duration drawn in "
                                  f"synthesize passed the duration pass's "
                                  f"headroom); its mel is cut at {m_bucket} "
                                  f"frames", flush=True)
                        out[i] = (r[0], mel[j, :n]) if wav is None else (
                            r[0], mel[j, :n],
                            wav[j, :min(n * hop, wav.shape[1])])
                # rows launched, and the requests among them (the rest
                # repeat the last); frames held and returned
                trace.count("serve.calls")
                trace.count("serve.rows", self.batch_size)
                trace.count("serve.rows_real", len(chunk))
                trace.count("serve.frames_held", self.batch_size * m_bucket)
                trace.count("serve.frames_out",
                            int(lens[:len(chunk)].sum()))
        return [o for o in out if o is not None]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("-c", "--config_path", type=str, default="config.json")
    p.add_argument("-m", "--model_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--sample_method", type=str, default="unipc",
                   choices=SAMPLE_METHODS)
    p.add_argument("--noise_scale", type=float, default=0.667)
    p.add_argument("--length_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="output")
    p.add_argument("--text_buckets", type=str, default=None,
                   help="comma-separated, e.g. 64,128,256")
    p.add_argument("--mel_buckets", type=str, default=None,
                   help="comma-separated mel-frame buckets, e.g. "
                        "400,800,1600 (default: max_mel_len x {1,2,4}); "
                        "long utterances pick a bigger bucket from a cheap "
                        "duration pass instead of truncating")
    p.add_argument("--vocoder_ckpt", type=str, default=None,
                   help="Vocos weights (a torch .bin/.pt in the published "
                        "layout, or the JAX package's .ckpt); enables .wav "
                        "output")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=list(DTYPES),
                   help="serving precision (bfloat16 weights; float32 for "
                        "parity runs)")
    p.add_argument("--dp", action="store_true",
                   help="shard each bucket batch over the ranks of the "
                        "torchrun process group (batch_size must be "
                        "divisible by their number); one rank without one")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, the rank's "
                        "own under torchrun)")
    p.add_argument("--trace_out", type=str, default=None,
                   help="write the port's spans and counters of the run "
                        "(core.trace) to this path as Chrome-trace JSON "
                        "(rank 0's)")
    args = p.parse_args(argv)
    if args.dp:
        mesh_lib.init_distributed(device=args.device)
        print(f"serve --dp: {mesh_lib.world_size()} data-parallel rank(s)"
              + ("" if mesh_lib.distributed() else
                 " (no process group: one rank, as JAX's mesh over one "
                 "device)"), flush=True)

    device = resolve_device(args.device)
    cfg = load_cli_config(args.config_path)

    def ints(text):
        return tuple(int(x) for x in text.split(",")) if text else None
    vocoder = load_vocoder(cfg, args.vocoder_ckpt, device=device) \
        if args.vocoder_ckpt else None
    syn = BatchSynthesizer(
        cfg, load_model_state_dict(args.model_path, cfg),
        batch_size=args.batch_size, steps=args.steps,
        sample_method=args.sample_method, noise_scale=args.noise_scale,
        length_scale=args.length_scale, text_buckets=ints(args.text_buckets),
        mel_buckets=ints(args.mel_buckets), vocoder=vocoder,
        dtype=DTYPES[args.dtype], device=device, dp=args.dp)
    rows = read_manifest(args.manifest)
    if args.trace_out:
        trace.enable(events=device.type == "cuda")
    results = syn.synthesize_all(rows, seed=args.seed)
    if args.trace_out:
        collected = trace.collect()
        trace.disable()
        if mesh_lib.rank() == 0:
            trace.export(args.trace_out, collected)
    if mesh_lib.rank() != 0:
        return
    os.makedirs(args.out_dir, exist_ok=True)
    for row in results:
        utt_id, mel = row[0], row[1]
        path = os.path.join(args.out_dir, f"{utt_id}.mel.npy")
        np.save(path, mel)
        print(f"{utt_id}: {mel.shape} -> {path}", flush=True)
        if len(row) > 2:
            wpath = os.path.join(args.out_dir, f"{utt_id}.wav")
            audio_lib.write_wav(wpath, row[2], cfg.data.sampling_rate)
            print(f"{utt_id}: wav -> {wpath}", flush=True)


if __name__ == "__main__":
    main()
    mesh_lib.shutdown_distributed()
