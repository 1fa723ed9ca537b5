"""Serving cells: offline synthesis jobs through the port's
``infer.serve.BatchSynthesizer.synthesize_all``, back to back.

A job is a list of tokenised requests (``traffic.serve_jobs``): the
serving front buckets them by text length, runs a duration pass to pick
each request's mel bucket, and makes one ``synthesize`` call a bucket
batch, then the vocoder. The window holds whole jobs: it runs from the
first job's start to the end of the last job that started before
``seconds`` had passed.

Every run records, for the check, which requests each ``synthesize`` call
took (a wrapper on the serving module's ``synthesize``), the seed of the
call's generator and the duration predictor's output (a forward hook).
A traced run also times the layers (``trace.Spans``) over one job and
profiles another.
"""
from __future__ import annotations

import functools
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, trace, traffic, work
from benchmark.weights import make_state_dict


class Recorder:
    """The ``synthesize`` calls of the serving front, with what the check
    and the work arithmetic need of each."""

    def __init__(self, serve_mod, model):
        self.calls: List[Dict] = []
        self.prepass: List[tuple] = []
        self.vocoder_calls: List[tuple] = []
        self._current = None
        inner = serve_mod.synthesize
        self._restore = (serve_mod, inner)

        def recorded(model_, text, text_lengths, refer, refer_lengths, tone,
                     language, *, generator=None, **kw):
            rec = {"text": text, "lengths": text_lengths,
                   "batch": text.shape[0],
                   "t_bucket": text.shape[1], "max_len": kw["max_len"],
                   "s_prompt": refer.shape[1], "seed": generator.initial_seed(),
                   "logw": None}
            self._current = rec
            try:
                out = inner(model_, text, text_lengths, refer, refer_lengths,
                            tone, language, generator=generator, **kw)
            finally:
                self._current = None
            rec["frames"] = out[1]
            self.calls.append(rec)
            return out
        serve_mod.synthesize = recorded

        def dp_out(mod, args, out):
            if self._current is not None:
                self._current["logw"] = out.detach()
        self._hook = model.vits.dp.register_forward_hook(dp_out)

        inner_pl = model.vits.predict_lengths

        def predict_lengths(x, x_lengths, y, *args, **kw):
            self.prepass.append((x.shape[0], x.shape[1], y.shape[1]))
            return inner_pl(x, x_lengths, y, *args, **kw)
        model.vits.predict_lengths = predict_lengths

    def ops(self, count, cfg, start: int, pre_start: int, voc_start: int,
            steps: int) -> List[work.Op]:
        """The work of the calls recorded since the given counts, by the
        reference's work count ``count`` (``references.Reference.work``)."""
        ops = []
        for c in self.calls[start:]:
            ops += count.synthesize(cfg, c["batch"], c["t_bucket"],
                                    c["max_len"], c["s_prompt"], 2, steps)
        for b, t_x, s in self.prepass[pre_start:]:
            ops += count.predict_lengths(cfg, b, t_x, s, 2)
        for b, t in self.vocoder_calls[voc_start:]:
            ops += count.vocoder(b, t, 4)
        return ops

    def useful_flops(self, count, cfg, start: int, voc_start: int,
                     steps: int) -> float:
        """Model operations of the requests served by the calls recorded
        since ``start``: each real row (not a repeat filling the batch) at
        its own text length and frame count, through ``synthesize`` and,
        where the run has one, the vocoder; bucket padding and the
        duration pass are left out."""
        vocoder = len(self.vocoder_calls) > voc_start
        total = 0.0
        for c in self.calls[start:]:
            lengths = c["lengths"].cpu().numpy()
            frames = c["frames"].cpu().numpy()
            for i in range(_real_rows(c["text"].cpu().numpy())):
                total += _row_flops(count, cfg, int(lengths[i]),
                                    int(frames[i]), c["s_prompt"], steps,
                                    vocoder)
        return total

    def marks(self):
        return len(self.calls), len(self.prepass), len(self.vocoder_calls)

    def close(self) -> None:
        """The serving module's own ``synthesize`` back."""
        mod, inner = self._restore
        mod.synthesize = inner
        self._hook.remove()


def speaking_rate(syn, requests, mix: Dict, seed: int) -> float:
    """The length scale at which ``requests`` (the jobs a window serves)
    speak ``mix["frames_per_token"]`` frames a token, each request's
    frames cut to the largest mel bucket as the serving front cuts them.
    Random weights speak at a rate of their own, which differs from seed
    to seed, and the rate sets how much audio a job makes. One duration
    pass of the program (``VITS.predict_lengths``) at scale 1 gives every
    token's duration (a forward hook on the predictor); the scale is then
    found on the host by bisection."""
    by_text: Dict[int, List] = {}
    for r in requests:
        t = min(b for b in syn.text_buckets if b >= len(r[1]))
        by_text.setdefault(t, []).append(r)
    logw: List[torch.Tensor] = []
    hook = syn.model.vits.dp.register_forward_hook(
        lambda mod, args, out: logw.append(out.detach()))
    durations = []
    for t, group in sorted(by_text.items()):
        for off in range(0, len(group), syn.batch_size):
            chunk = group[off:off + syn.batch_size]
            gen = torch.Generator().manual_seed(_job_seed(seed, off + t))
            with torch.inference_mode():
                syn.model.vits.predict_lengths(*syn.pad_batch(chunk, t),
                                               generator=gen)
            w = torch.exp(logw[-1][:len(chunk), :, 0].float()).cpu().numpy()
            durations += [w[i, :len(r[1])] for i, r in enumerate(chunk)]
    hook.remove()
    flat = np.concatenate(durations)
    starts = np.cumsum([0] + [len(d) for d in durations[:-1]])
    cap = max(syn.mel_buckets)
    target = mix["frames_per_token"] * len(flat)

    def frames(scale):
        per = np.add.reduceat(np.ceil(flat * scale), starts)
        return np.minimum(np.maximum(per, 1), cap).sum()

    lo, hi = 1e-3, 1e3
    for _ in range(60):
        mid = (lo * hi) ** 0.5
        lo, hi = (mid, hi) if frames(mid) < target else (lo, mid)
    return float(hi)


def warm_requests(syn, requests) -> List:
    """Requests that make one ``synthesize`` call of every shape a job of
    ``requests`` makes: with one mel bucket, one request a text bucket;
    with several, the whole job (which bucket a request takes is known
    only after the duration pass)."""
    if len(syn.mel_buckets) > 1:
        return list(requests)
    first = {}
    for r in requests:
        first.setdefault(min(b for b in syn.text_buckets if b >= len(r[1])),
                         r)
    return list(first.values())


def _job_seed(seed: int, j: int) -> int:
    return (seed * 7919 + j) % 2 ** 31


def run(reference, cfg_dict: Dict, mix: Dict, seed: int, seconds: float,
        traced: bool, device: torch.device, t0: float,
        control: bool = False) -> Dict:
    """One serving run from process start ``t0`` of the configuration
    ``cfg_dict``, checked against its plain reference ``reference``
    (``references.resolve``): the end-to-end metrics, what the traced run
    read (``ctx``), the numbers the check compares, requests attempted and
    failed, and the window's peak memory. ``control``: also the control's
    numbers on the same sample (``benchmark.control``)."""
    from diff_vits_tpu_torch.core.config import Config
    from diff_vits_tpu_torch.infer import serve as serve_mod
    from diff_vits_tpu_torch.models.vocoder import Vocos
    from diff_vits_tpu_torch.text.symbols import symbols

    marks_s = [("imports", time.perf_counter() - t0)]
    cfg = Config.from_dict(cfg_dict)
    rcfg = reference.Config.from_dict(cfg_dict)
    n_vocab = cfg_dict["n_vocab"]
    if n_vocab != len(symbols):
        raise ValueError(f"n_vocab {n_vocab} is not the port's {len(symbols)}")
    dtype = getattr(torch, mix["dtype"])
    with torch.device("meta"):
        meta = reference.DiffVits(rcfg, n_vocab)
        meta_voc = reference.Vocos(cfg.data.n_mel_channels)
    sd = make_state_dict(meta, seed, device, dtype)
    trace.sync(device)
    marks_s.append(("weights", time.perf_counter() - t0))
    vocoder = None
    if mix["vocoder"]:
        vocoder = Vocos(n_mels=cfg.data.n_mel_channels,
                        n_fft=cfg.data.window_size,
                        hop_length=cfg.data.hop_length, device=device)
        vocoder.load_state_dict(make_state_dict(meta_voc, seed + 1, device,
                                                torch.float32))
    syn = serve_mod.BatchSynthesizer(
        cfg, sd, batch_size=mix["batch_size"], steps=mix["steps"],
        sample_method=mix["sample_method"], noise_scale=mix["noise_scale"],
        length_scale=1.0, text_buckets=mix["text_buckets"],
        refer_frames=mix["prompt_frames"], mel_buckets=mix["mel_buckets"],
        vocoder=vocoder, dtype=dtype, device=device)
    del sd
    marks_s.append(("model", time.perf_counter() - t0))
    rec = Recorder(serve_mod, syn.model)
    if vocoder is not None:
        syn.vocoder.register_forward_pre_hook(
            lambda m, a: rec.vocoder_calls.append(tuple(a[0].shape[:2])))
    spans = trace.Spans(device)
    if traced:
        spans.wrap(syn.model.vits, "infer", "prior")
        spans.wrap(syn.model.diff_model, "denoise", "denoise")
        spans.wrap(serve_mod, "synthesize", "synthesize")
        if vocoder is not None:
            spans.hook(syn.vocoder, "vocoder")
        spans.wrap(syn, "synthesize_all", "job")
    jobs = traffic.serve_jobs(mix, seed, n_vocab, cfg.data.n_mel_channels,
                              mix["max_jobs"])
    hop, rate = cfg.data.hop_length, cfg.data.sampling_rate

    def job(j):
        return j, syn.synthesize_all(jobs[j], seed=_job_seed(seed, j))

    # set-up: the speaking rate, then a call of every shape the traffic
    # takes
    syn.length_scale = speaking_rate(
        syn, [r for j in jobs[1:1 + mix["rate_jobs"]] for r in j], mix, seed)
    mix = dict(mix, length_scale=syn.length_scale)
    marks_s.append(("rate", time.perf_counter() - t0))
    syn.synthesize_all(warm_requests(syn, jobs[0]), seed=_job_seed(seed, 0))
    trace.sync(device)
    setup_s = time.perf_counter() - t0
    print("serve: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in marks_s)
          + f", warm {setup_s:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = len(rec.calls)

    done: List[tuple] = []          # (job index, results)
    ctx: Dict = {"spans": spans}
    t_start = time.perf_counter()
    marks = rec.marks()
    while len(done) + 1 < len(jobs):
        done.append(job(len(done) + 1))
        if time.perf_counter() - t_start >= (seconds / 2 if traced
                                             else seconds):
            break
    if traced:
        wall = time.perf_counter() - t_start
        ctx["mfu"] = (rec.useful_flops(reference.work, rcfg, marks[0],
                                       marks[2], mix["steps"]), wall)
        spans.on = True
        done.append(job(len(done) + 1))
        spans.on = False
        marks = rec.marks()
        res, ctx["profile"] = trace.profile(
            lambda: job(len(done) + 1), device)
        done.append(res)
        ctx["profile_ops"] = rec.ops(reference.work, rcfg, *marks,
                                     mix["steps"])
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if len(done) + 1 >= len(jobs):
        raise RuntimeError(f"the window ran out of its {len(jobs)} jobs")

    frames = [len(r[1]) for _, res in done for r in res]
    tokens = [len(req[1]) for j, _ in done for req in jobs[j]]
    print(f"serve: set-up {setup_s:.3f} s, length scale "
          f"{syn.length_scale:.5f}; {len(done)} jobs in {window_s:.3f} s, "
          f"{sum(frames) / sum(tokens):.4f} frames a token, "
          f"{len(rec.calls) - first} synthesize calls", file=sys.stderr)
    ctx["frame_fill"] = _frame_fill(rec.calls[first:])
    end_to_end = {
        "audio_s_per_s": traffic.audio_seconds(frames, hop, rate) / window_s,
        "setup_s": setup_s}

    # the check, with the program's state freed first
    samples = _sample(done, jobs, rec.calls[first:], seed,
                      mix["check_requests"])
    spans.close()
    rec.close()
    del syn, rec, vocoder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.DiffVits(rcfg, n_vocab).to(device)
    ref.load_state_dict({k: v.float() for k, v in make_state_dict(
        ref, seed, device, dtype).items()})
    ref.eval()
    rvoc = reference.Vocos(cfg.data.n_mel_channels).to(device).eval()
    rvoc.load_state_dict(make_state_dict(rvoc, seed + 1, device,
                                         torch.float32))
    numbers = check.judge_serving(reference, samples, ref, rvoc, mix, hop,
                                  mix["prompt_frames"], device)
    if control:
        ctx["control"] = check.judge_serving(
            reference, samples, ref, rvoc, mix, hop, mix["prompt_frames"],
            device, control=True)
    return dict(end_to_end=end_to_end, ctx=ctx, numbers=numbers,
                attempted=sum(len(jobs[i]) for i, _ in done),
                failed=sum(len(jobs[i]) - len(res) for i, res in done),
                peak=peak)


@functools.lru_cache(maxsize=None)
def _row_flops(count, cfg, t_x: int, t_y: int, s_prompt: int, steps: int,
               vocoder: bool) -> float:
    ops = count.synthesize(cfg, 1, t_x, t_y, s_prompt, 2, steps)
    if vocoder:
        ops += count.vocoder(1, t_y, 4)
    return work.total_flops(ops)


def _real_rows(text: np.ndarray) -> int:
    """Rows of a padded batch before its repeats of the last request."""
    n = text.shape[0]
    while n > 1 and np.array_equal(text[n - 2], text[-1]):
        n -= 1
    return n


def _frame_fill(calls: List[Dict]) -> float:
    """Real output frames over rows x mel-bucket frames, in percent, over
    ``synthesize`` calls (repeat rows count as empty)."""
    real, held = 0, 0
    for c in calls:
        n = _real_rows(c["text"].cpu().numpy())
        held += c["batch"] * c["max_len"]
        real += int(c["frames"][:n].sum())
    return 100.0 * real / held if held else float("nan")


def _sample(done, jobs, calls: List[Dict], seed: int, k: int) -> List[Dict]:
    """``k`` requests of the finished jobs, drawn from the seed, the one
    with the most frames among them; each with its call and row."""
    pool = [(req, out) for j, res in done for req, out in zip(jobs[j], res)]
    rng = np.random.default_rng([seed % 2 ** 63, 7])
    longest = max(range(len(pool)), key=lambda i: len(pool[i][1][1]))
    rest = [i for i in range(len(pool)) if i != longest]
    pick = [longest] + [int(i) for i in rng.choice(
        rest, size=min(k - 1, len(rest)), replace=False)]
    where = {}
    for c in calls:
        text = c["text"].cpu().numpy()
        for row in range(text.shape[0]):
            where.setdefault((text.shape[1], text[row].tobytes()), (c, row))
    samples = []
    for i in pick:
        req, out = pool[i]
        found = [where.get((t, _padded(req[1], t).tobytes()))
                 for t in sorted({k[0] for k in where}) if t >= len(req[1])]
        found = [f for f in found if f is not None]
        if not found:
            raise KeyError(f"no synthesize call served {req[0]}")
        call, row = found[0]
        samples.append({"req": req, "call": call, "row": row,
                        "mel": out[1], "wav": out[2] if len(out) > 2
                        else None})
    return samples


def _padded(ids, t: int) -> np.ndarray:
    out = np.zeros(t, np.int64)
    out[:len(ids)] = ids
    return out
