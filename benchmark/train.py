"""Training cells: ``train.trainer.Trainer.train_step`` on loader-shaped
batches cycled from a pool made in set-up from the seed.

Set-up builds one Trainer, loads the benchmark's weights into it and
drives it through its first ``check_steps`` steps on distinct batches,
keeping what the check compares: each step's loss and MAS call, the first
gradient as AdamW got it (its first moment after one step over 1 -
beta1), and the parameters' change after the last of those steps. The
same Trainer then runs the window.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time
from typing import Dict

import torch

from benchmark import check, trace, traffic, work
from benchmark.weights import make_state_dict


def config(cfg_dict: Dict, mix: Dict, seed: int) -> Dict:
    """The configuration as the step runs it: the mix's batch, EMA and
    precision, the run's seed."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in cfg_dict.items()}
    out["train"].update(train_batch_size=mix["batch_size"],
                        use_ema=mix["use_ema"],
                        compute_dtype=mix["compute_dtype"],
                        seed=seed % 2 ** 62)
    return out


def first_steps(trainer, batches, p0, n: int) -> Dict:
    """Run ``n`` steps and read what the check compares, with each step's
    MAS call (its scores, mask and path, kept on the host: a wrapper on
    the name the prior calls it by)."""
    from diff_vits_tpu_torch.models import vits as vits_mod
    beta1 = trainer.cfg.train.adam_betas[0]
    losses, norms, grad, mas = [], [], None, []
    inner = vits_mod.maximum_path

    def recorded(neg_cent, mask):
        path = inner(neg_cent, mask)
        mas.append(tuple(t.detach().to("cpu", torch.float32)
                         for t in (neg_cent, mask, path)))
        return path
    vits_mod.maximum_path = recorded
    try:
        for i in range(n):
            m = trainer.train_step(batches[i])
            losses.append(m["loss/all"])
            norms.append(m["loss/grad"])
            if i == 0:
                st = trainer.optimizer.state
                grad = check.leaf_norms([st[p]["exp_avg"] / (1 - beta1)
                               for p in trainer.params])
    finally:
        vits_mod.maximum_path = inner
    out = {"loss": [float(x) for x in losses], "grad": grad, "mas": mas,
           "grad_norm": [float(x) for x in norms],
           "update": check.leaf_norms([p.detach() - p0[k] for k, p in
                             zip(trainer.names, trainer.params)])}
    return out


def step_ops(reference, rcfg, mix: Dict):
    """A step's forward products by the reference's work count, at the
    mix's batch and crops (bf16 operands)."""
    return reference.work.train_forward(
        rcfg, mix["batch_size"], mix["text_buffer"], mix["mel_crop"],
        mix["prompt_frames"], 2)


def run(reference, cfg_dict: Dict, mix: Dict, seed: int, seconds: float,
        traced: bool, device: torch.device, t0: float,
        control: bool = False) -> Dict:
    """One training run from process start ``t0``; as ``serve.run``.
    ``control``: also the numbers of the control and of the planted
    fault that leaves half of each batch out (``benchmark.control``)."""
    from diff_vits_tpu_torch.core.config import Config
    from diff_vits_tpu_torch.data.batch import Batch
    from diff_vits_tpu_torch.text.symbols import symbols
    from diff_vits_tpu_torch.train.trainer import Trainer

    run_cfg = config(cfg_dict, mix, seed)
    cfg = Config.from_dict(run_cfg)
    rcfg = reference.Config.from_dict(run_cfg)
    n_vocab = run_cfg["n_vocab"]
    if n_vocab != len(symbols):
        raise ValueError(f"n_vocab {n_vocab} is not the port's {len(symbols)}")
    pool = traffic.train_batches(mix, seed, n_vocab,
                                 cfg.data.n_mel_channels, mix["pool"])
    batches = [Batch(**b) for b in pool]
    t_data = time.perf_counter() - t0
    # nothing is saved: the workdir is never made
    trainer = Trainer(cfg, batches=[], device=device,
                      workdir=os.path.join(tempfile.gettempdir(), "bench"))
    t_trainer = time.perf_counter() - t0
    with torch.device("meta"):
        meta = reference.DiffVits(rcfg, n_vocab)
    p0 = make_state_dict(meta, seed, device, torch.float32)
    trainer.model.load_state_dict(p0)
    if trainer.ema is not None:
        trainer.ema = [p.detach().float().clone() for p in trainer.params]
    n_check = mix["check_steps"]
    names = list(trainer.names)
    t_model = time.perf_counter() - t0
    prog = first_steps(trainer, batches, p0, n_check)
    del p0
    trace.sync(device)
    setup_s = time.perf_counter() - t0
    print(f"train: set-up imports and batches {t_data:.3f}, Trainer "
          f"{t_trainer:.3f}, weights {t_model:.3f}, first steps "
          f"{setup_s:.3f} s", file=sys.stderr)

    spans = trace.Spans(device)
    if traced:
        spans.hook(trainer.model, "forward")
        spans.wrap(trainer, "train_step", "step")
    ctx: Dict = {"spans": spans}
    ops = step_ops(reference, rcfg, mix)
    k = n_check

    def step():
        nonlocal k
        trainer.train_step(batches[k % len(batches)])
        k += 1

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_start = time.perf_counter()
    n = 0
    while True:
        step()
        n += 1
        if time.perf_counter() - t_start >= (seconds / 2 if traced
                                             else seconds):
            break
    trace.sync(device)
    wall = time.perf_counter() - t_start
    if traced:
        ctx["mfu"] = (n * work.train_flops(ops), wall)
        spans.on = True
        for _ in range(3):
            step()
        spans.on = False
        _, ctx["profile"] = trace.profile(lambda: [step() for _ in range(3)],
                                          device)
        ctx["profile_ops"] = 3 * work.train_ops(ops)
    window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print(f"train: {n} steps in {wall:.3f} s (window {window_s:.3f} s); "
          f"losses {prog['loss']}", file=sys.stderr)
    end_to_end = {"train_step_ms": 1e3 * wall / n,
                  "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s}

    spans.close()
    del trainer, batches[n_check:]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.DiffVits(rcfg, n_vocab).to(device)
    ref.load_state_dict(make_state_dict(ref, seed, device, torch.float32))
    first = [batches[i] for i in range(n_check)]
    state = make_state_dict(ref, seed, device, torch.float32)

    def steps(**kw):
        ref.load_state_dict(state)
        return check.reference_steps(reference, ref, run_cfg, first,
                                     mix["check_block_rows"], device, **kw)
    paths = [path for _, _, path in prog["mas"]]
    if [len(p) for p in paths] != [len(b.text) for b in first]:
        # the step did not align every row it was given
        numbers = dict.fromkeys(("loss_gap", "grad_gap", "update_gap",
                                 "mas_mismatch"), math.inf)
    else:
        numbers = check.judge_training(prog, steps(paths=paths), names)
        numbers["mas_mismatch"] = check.mas_mismatch(reference, prog["mas"],
                                                     device)
    if control:
        fp8 = steps(control=True)
        half = steps(rows=mix["batch_size"] // 2)
        ctx["control"] = {
            "fp8": check.judge_training(fp8, steps(paths=fp8["paths"])),
            "half_batch": check.judge_training(half, steps())}
    return dict(end_to_end=end_to_end, ctx=ctx, numbers=numbers,
                attempted=n, failed=0, peak=peak)
