"""How ``correct`` is decided: the outputs the timed path produced,
compared with the plain reference after the window has closed.

Serving. A sample of the requests finished in the window, drawn from the
seed with the longest among them, is worked out again by the reference in
float32 (TF32 off), row by row from the same padded inputs and the same
generator draws as the program's call that served it (``draws.rows``
gives each row its share of the whole batch's draws). Where the program's
log durations round to other frame counts than the reference's would, the
mel cannot be compared frame by frame, so the reference expands the text
by the program's own counts (worked out again from the program's log
durations in the program's dtype) and the log durations are compared on
their own. The numbers (a cell's limits file says which it compares):

* ``logw_rms`` / ``logw_max``: the root mean square and the largest gap
  between the program's and the reference's log durations over the
  sample's real tokens;
* ``mel_gap`` / ``mel_max``: the relative L2 gap of the sample's mels
  taken together, and the largest of a single request's;
* ``wav_gap`` / ``wav_max``: the same of the waveforms (the reference's
  Vocos over the reference's mel);
* ``frames_gap``: the sample's frames, each request's total as the
  program served it against the total the reference's own float32 log
  durations give (cut to the call's mel bucket), as the sum of the
  absolute gaps over the sum of the reference's totals.

Training. The reference follows the first ``check_steps`` steps that set-up
ran through ``Trainer.train_step`` (``benchmark.train``), from the same
weights, batches and generator draws, in float32. MAS is discrete: where
the program's bfloat16 scores put a frame on another token than the
reference's float32 scores would, the losses and gradients part by more
than precision, so the reference takes each step's alignment from the
program's own MAS call, and that call is checked on its own: the
reference's MAS over the program's scores gives the same path. The
numbers: ``mas_mismatch`` (the share of path entries that differ, limit
0), ``loss_gap`` (the largest relative gap of a step's loss), and by leaf
``grad_*`` (the first gradient as AdamW got it) and ``update_*`` (the
parameters' change after the last step): ``*_gap`` the worst leaf's gap
of norms over the larger of that leaf's and the median leaf's reference
norm, ``*_median`` the median leaf's gap over its own.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import draws, plain_math
from benchmark.reference.quant import fp8_products


@contextlib.contextmanager
def tf32():
    """TF32 products for float32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """||a - b|| / ||b||; inf when the shapes differ or a is not finite."""
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / max(den, 1e-12)


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[:min(n, len(a))] = a[:n]
    return out


def _inputs(requests, t_bucket: int, refer_frames: int, device):
    """The padded inputs of rows of a call, as the serving front pads
    them: ids to the call's text bucket, prompts cut or zero-padded."""
    def ids(k):
        return torch.from_numpy(np.stack(
            [_pad(np.asarray(r[k]), t_bucket) for r in requests])).to(device)
    return (ids(1), torch.tensor([len(r[1]) for r in requests],
                                 device=device),
            torch.from_numpy(np.stack([_pad(np.asarray(r[4], np.float32),
                                            refer_frames)
                                       for r in requests])).to(device),
            torch.full((len(requests),), refer_frames, device=device),
            ids(2), ids(3))


def frame_counts(logw: torch.Tensor, lengths: torch.Tensor,
                 length_scale: float):
    """Per-token frame counts [B, Tx] and their totals [B] from log
    durations [B, Tx, 1], in the log durations' own dtype, as the prior
    works them out (in bfloat16 a total over 256 frames rounds to the
    dtype's step there: the program keeps that total)."""
    t = logw.shape[1]
    mask = (torch.arange(t, device=logw.device)[None] < lengths.to(
        logw.device)[:, None]).to(logw.dtype)[..., None]
    w_ceil = torch.ceil(torch.exp(logw) * mask * length_scale)[..., 0]
    total = torch.clamp(w_ceil.sum(dim=-1), min=1.0).to(torch.int32)
    return w_ceil, total


def judge_serving(reference, samples: List[Dict], ref, vocos, mix: Dict,
                  hop: int, refer_frames: int, device, control: bool = False
                  ) -> Dict[str, float]:
    """The numbers of the model ``ref`` and the vocoder ``vocos`` of the
    plain reference ``reference`` (``references.resolve``; its
    ``synthesize`` runs them) over ``samples``: dicts with the request
    (``req``), its call record (``call``: ``seed``, ``batch``,
    ``max_len``, ``t_bucket``, ``logw``), its ``row`` and the program's
    trimmed ``mel`` and ``wav``. ``control``: the reference in float8 products
    stands in for the program (its own durations, mel and waveform, TF32
    on for its vocoder)."""
    acc = {"logw": [0.0, 0, 0.0], "mel": [0.0, 0.0, 0.0],
           "wav": [0.0, 0.0, 0.0],      # sum sq gap, sum sq ref / count, max
           "frames": [0.0, 0.0, 0.0]}   # sum abs gap, sum ref, max

    def add(key, gap, ref_, rel):
        a = acc[key]
        a[0] += gap
        a[1] += ref_
        a[2] = max(a[2], rel)

    by_call: Dict[int, List[Dict]] = {}
    for s in samples:
        by_call.setdefault(id(s["call"]), []).append(s)
    for group in by_call.values():
        call = group[0]["call"]
        rows = [s["row"] for s in group]
        inputs = _inputs([s["req"] for s in group], call["t_bucket"],
                         refer_frames, device)
        kw = dict(max_len=call["max_len"], noise_scale=mix["noise_scale"],
                  length_scale=mix["length_scale"], steps=mix["steps"])

        def run(counts=(None, None)):
            gen = torch.Generator().manual_seed(call["seed"])
            with draws.rows(rows, call["batch"]), plain_math():
                return reference.synthesize(ref, *inputs, generator=gen,
                                            w_ceil=counts[0],
                                            out_lengths=counts[1], **kw)
        if control:
            with fp8_products(ref):
                mel_c, n_c, logw_c = run()
            with tf32(), torch.no_grad():
                wav_c = vocos(mel_c).cpu().numpy()
            prog_logw = logw_c.float()
            counts = frame_counts(logw_c, inputs[1], mix["length_scale"])
            prog = [(mel_c[i, :int(n_c[i])].cpu().numpy(),
                     wav_c[i, :int(n_c[i]) * hop]) for i in range(len(rows))]
        else:
            logw_p = call["logw"][rows]
            prog_logw = logw_p.float()
            counts = frame_counts(logw_p, inputs[1], mix["length_scale"])
            prog = [(s["mel"], s["wav"]) for s in group]
        mel_r, n_r, logw_r = run((counts[0].float(), counts[1]))
        with plain_math(), torch.no_grad():
            wav_r = vocos(mel_r).cpu().numpy()
        real = (torch.arange(logw_r.shape[1], device=device)[None]
                < inputs[1][:, None])
        gap = (prog_logw - logw_r.float()).abs()[..., 0][real]
        add("logw", float((gap ** 2).sum()), gap.numel(), float(gap.max()))
        own = torch.clamp(frame_counts(logw_r.float(), inputs[1],
                                       mix["length_scale"])[1],
                          max=call["max_len"])
        for i, (mel_p, wav_p) in enumerate(prog):
            n = int(n_r[i])
            n_own = int(own[i])
            add("frames", abs(len(mel_p) - n_own), n_own,
                abs(len(mel_p) - n_own) / n_own)
            for key, p_, r_ in (("mel", mel_p, mel_r[i, :n].cpu().numpy()),
                                ("wav", wav_p, wav_r[i, :n * hop])):
                if p_ is None:
                    continue
                rel = rel_l2(p_, r_)
                sq = (float(np.sum((p_ - r_) ** 2)) if math.isfinite(rel)
                      else math.inf)
                add(key, sq, float(np.sum(r_ ** 2)), rel)
            print(f"check {group[i]['req'][0]}: {len(mel_p)} frames "
                  f"(reference {n} by the program's durations, {n_own} by "
                  f"its own), max |mel| {np.abs(mel_p).max():.4g} "
                  f"(reference {float(mel_r[i, :n].abs().max()):.4g}), "
                  f"mel gap {rel_l2(mel_p, mel_r[i, :n].cpu().numpy()):.4g}",
                  file=sys.stderr)
    out = {"logw_rms": math.sqrt(acc["logw"][0] / max(acc["logw"][1], 1)),
           "logw_max": acc["logw"][2]}
    for key in ("mel", "wav"):
        s_gap, s_ref, worst = acc[key]
        if s_ref > 0:
            out[f"{key}_gap"] = math.sqrt(s_gap / s_ref)
            out[f"{key}_max"] = worst
    out["frames_gap"] = acc["frames"][0] / max(acc["frames"][1], 1.0)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is finite and within its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= v for k, v in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, List[Optional[float]]]:
    """{name: [number, limit]} of the numbers compared, for the result
    line; a number that is not finite (an answer missing, of the wrong
    length or not a number) is null there."""
    def finite(v):
        return v if v is not None and math.isfinite(v) else None
    return {k: [finite(numbers.get(k)), v] for k, v in sorted(limits.items())}


# -- training -------------------------------------------------------------

def _fields(batch, use_refer1: bool, device) -> Dict[str, torch.Tensor]:
    """The loss's inputs from a loader-shaped batch, with refer1 or refer2
    as the prompt."""
    r = "refer1" if use_refer1 else "refer2"

    def t(name, dtype):
        return torch.as_tensor(np.asarray(getattr(batch, name)),
                               dtype=dtype, device=device)
    return dict(text=t("text", torch.int64),
                text_lengths=t("text_lengths", torch.int64),
                spec=t("spec", torch.float32),
                spec_lengths=t("spec_lengths", torch.int64),
                refer=t(r, torch.float32),
                refer_lengths=t(f"{r}_lengths", torch.int64),
                tone=t("tone", torch.int64),
                language=t("language", torch.int64))


def leaf_norms(tensors) -> List[float]:
    return [float(n) for n in torch.stack(
        [torch.linalg.vector_norm(x.float()) for x in tensors]).cpu()]


def reference_steps(reference, ref, run_cfg: Dict, batches, block_rows: int,
                    device, control: bool = False, rows: Optional[int] = None,
                    paths: Optional[List[torch.Tensor]] = None) -> Dict:
    """The first ``len(batches)`` optimizer steps of the model ``ref`` of
    the plain reference ``reference`` (whose ``Config`` reads ``run_cfg``)
    from the program's initial weights, as ``Trainer.step_on`` takes them:
    the MAS noise's anneal, the refer1 / refer2 coin, the step's draws
    from a generator on ``device`` seeded as the Trainer's, the loss over
    the whole batch (run ``block_rows`` rows at a time, the MAS noise
    scaled by the whole batch's standard deviation from a first pass), the
    global norm clip and AdamW (weight decay 1e-4). ``control``: the
    products in float8; ``rows``: only each batch's first ``rows`` rows (a
    planted fault: the rest of the batch left out). Returns each step's
    loss, and by leaf the first gradient as AdamW got it and the
    parameters' change."""
    import random

    tc = reference.Config.from_dict(run_cfg).train
    ref.train()
    params = list(ref.parameters())
    p0 = [p.detach().clone() for p in params]
    opt = torch.optim.AdamW(params, lr=tc.train_lr,
                            betas=tuple(tc.adam_betas), eps=tc.eps,
                            weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(tc.seed)
    coin = random.Random(tc.seed + 17)
    out: Dict = {"loss": []}
    scope = fp8_products(ref) if control else contextlib.nullcontext()
    with scope, plain_math():
        for step, batch in enumerate(batches):
            mas = max(tc.mas_noise_scale_initial
                      - tc.noise_scale_delta * step, 0.0)
            f = _fields(batch, coin.random() < 0.5, device)
            if rows is not None:
                f = {k: v[:rows] for k, v in f.items()}
            b = f["text"].shape[0]
            blocks = [slice(i, min(i + block_rows, b))
                      for i in range(0, b, block_rows)]
            norms = dict(n_text=f["text_lengths"].sum().float(),
                         n_frames=f["spec_lengths"].sum().float(), b_total=b)
            opt.zero_grad(set_to_none=True)
            start = gen.get_state()
            s1 = s2 = 0.0
            count = 0
            path = None if paths is None else paths[step]
            with torch.no_grad():
                for sl in blocks if path is None else []:
                    gen.set_state(start)
                    with draws.rows(sl, b):
                        nc, _ = ref.vits.neg_cent(
                            f["text"][sl], f["text_lengths"][sl],
                            f["spec"][sl], f["spec_lengths"][sl],
                            f["tone"][sl], f["language"][sl], generator=gen)
                    s1 += float(nc.double().sum())
                    s2 += float((nc.double() ** 2).sum())
                    count += nc.numel()
            mean = s1 / max(count, 1)
            std = torch.tensor(math.sqrt(max(s2 / max(count, 1) - mean * mean,
                                             0.0)), device=device)
            loss = 0.0
            used = []
            for sl in blocks:
                gen.set_state(start)
                with draws.rows(sl, b):
                    terms = ref.loss(
                        **{k: v[sl] for k, v in f.items()}, generator=gen,
                        mas_noise_scale=mas, mas_std=std,
                        path=None if path is None else path[sl], **norms)
                terms["loss/all"].backward()
                loss += float(terms["loss/all"].detach())
                used.append(terms["path"])
            out["loss"].append(loss)
            out.setdefault("paths", []).append(torch.cat(used).to(torch.uint8))
            grads = [p.grad for p in params if p.grad is not None]
            g_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            out.setdefault("grad_norm", []).append(float(g_norm))
            max_norm = (tc.clip_before if step < tc.clip_switch_step
                        else tc.clip_after)
            for g in grads:
                g.mul_(torch.clamp(max_norm / (g_norm + 1e-6), max=1.0))
            opt.step()
            if step == 0:
                out["grad"] = leaf_norms(
                    [opt.state[p]["exp_avg"] / (1 - tc.adam_betas[0])
                     if p in opt.state else torch.zeros(())
                     for p in params])
    out["update"] = leaf_norms([p.detach() - q for p, q in zip(params, p0)])
    return out


def mas_mismatch(reference, mas, device) -> float:
    """The largest share, over the steps, of alignment entries where the
    program's MAS path differs from the reference's MAS
    (``reference.maximum_path``) over the same scores and mask (an exact
    comparison: the path is discrete)."""
    worst = 0.0
    for neg_cent, mask, path in mas:
        with torch.no_grad():
            mine = reference.maximum_path(neg_cent.to(device),
                                          mask.to(device))
        worst = max(worst, float((mine.cpu() != path).float().mean()))
    return worst


def _leaf_gaps(prog: List[float], ref: List[float], keep: List[bool],
               names: Optional[List[str]] = None, what: str = ""):
    """(the largest gap between the program's and the reference's norm of
    a kept leaf over the larger of that leaf's and the median leaf's
    reference norm, the median over the kept leaves of the gap over the
    leaf's own reference norm)."""
    if not all(math.isfinite(p) for p in prog):
        return math.inf, math.inf
    med = float(np.median([r for r, k in zip(ref, keep) if k]))
    gaps = [(abs(p - r) / max(r, med), i) for i, (p, r, k) in
            enumerate(zip(prog, ref, keep)) if k]
    worst, i = max(gaps)
    if names is not None:
        print(f"check {what}: worst leaf {names[i]} program {prog[i]:.4g} "
              f"reference {ref[i]:.4g} median leaf {med:.4g}",
              file=sys.stderr)
    return worst, float(np.median([abs(p - r) / r for p, r, k in
                                   zip(prog, ref, keep) if k]))


def judge_training(prog: Dict, ref: Dict,
                   names: Optional[List[str]] = None) -> Dict[str, float]:
    """The training numbers: ``loss_gap`` the largest relative gap of a
    step's loss; ``grad_gap`` and ``update_gap`` the worst leaf's gap of
    the first gradient's and the parameters' change's norms, and
    ``grad_median`` and ``update_median`` the median leaf's, over the
    leaves whose reference gradient is at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone)."""
    med = float(np.median(ref["grad"]))
    keep = [g >= 1e-3 * med for g in ref["grad"]]
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
             for p, r in zip(prog["loss"], ref["loss"])]
    print("check loss gap by step " + " ".join(f"{g:.4g}" for g in steps)
          + f"; {sum(keep)} of {len(keep)} leaves compared; gradient norm "
          f"before the clip {prog.get('grad_norm')} (reference "
          f"{ref.get('grad_norm')})", file=sys.stderr)
    numbers = {"loss_gap": max(steps)}
    for k in ("grad", "update"):
        if k in prog and k in ref:
            numbers[f"{k}_gap"], numbers[f"{k}_median"] = _leaf_gaps(
                prog[k], ref[k], keep, names, k)
    return numbers
