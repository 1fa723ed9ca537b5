"""Data parallelism run in spawned processes on one host, and the
data-parallel checks that the CPU tests and ``chip_smoke.py`` hold to one
process.

:func:`run_ranks` starts ``world`` processes (``spawn``), each a rank of a
process group on ``localhost`` with the backend named, calls
``fn(*args)`` there and returns every rank's result; ``torchrun`` does
the same for real runs. A function sent to the ranks must be importable
(spawned processes unpickle it by its module path), which is why the
checks live here and not in the tests:

* :func:`train_step` runs one ``Trainer`` step on the rank's rows of
  global micro-batches; :func:`serve` runs ``BatchSynthesizer(dp=True)``;
  :func:`train_cli` the training command line.
  On one process (no process group) they are the single-process step and
  serving run the ranks are held to. :func:`calls` runs several such
  calls in one set of ranks.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               threads: int, fn: Callable, args: tuple, results) -> None:
    from diff_vits_tpu_torch.parallel.mesh import (
        init_distributed, shutdown_distributed)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    try:
        init_distributed(backend=backend)
        results.put((rank, fn(*args), None))
    except BaseException:  # sent to the parent, which raises it
        results.put((rank, None, traceback.format_exc()))
    finally:
        shutdown_distributed()


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              threads: int = 1, timeout: float = 120.0) -> List[Any]:
    """``fn(*args)`` on each of ``world`` spawned ranks of a ``backend``
    process group; the results in rank order. Raises RuntimeError with the
    rank's traceback when one fails, and TimeoutError (the ranks killed)
    when they do not all answer within ``timeout`` seconds."""
    import multiprocessing as mp
    import queue
    import time
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, threads, fn, args,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    deadline = time.monotonic() + timeout
    try:
        # every rank answers, a failed one with its traceback (the others
        # then fail in their next collective); a rank that dies without
        # an answer is reported by its exit code
        while len(out) + len(errors) < world:
            try:
                rank, value, err = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in errors:
                        errors[r] = (f"exited with code {p.exitcode} "
                                     "without an answer")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the ranks gave {len(out)} of {world} results in "
                        f"{timeout} s; failures: {errors}") from None
                continue
            if err is None:
                out[rank] = value
            else:
                errors[rank] = err
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(f"rank {r}:\n{e}"
                                      for r, e in sorted(errors.items())))
    return [out[r] for r in range(world)]


def calls(jobs: Sequence[tuple]) -> List[Any]:
    """``fn(*args, **kwargs)`` for each ``(fn, args)`` or ``(fn, args,
    kwargs)`` of ``jobs``, in order; their results."""
    return [job[0](*job[1], **(job[2] if len(job) > 2 else {}))
            for job in jobs]


def batch_rows(batch, rows_: slice):
    """The rows ``rows_`` of every field of a ``data.batch.Batch``."""
    return dataclasses.replace(batch, **{
        f.name: np.asarray(getattr(batch, f.name))[rows_]
        for f in dataclasses.fields(batch)})


def train_step(cfg, micro: Sequence, device: str = "cpu",
               inject: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]]
               = None) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """One ``Trainer(cfg)`` step on this rank's rows of the global
    micro-batches ``micro`` (``train.gradient_accumulate_every`` of them);
    returns (the parameters after it by name as float32 arrays, the
    metrics averaged over the ranks).

    The draws are the single process's: every rank's generator restarts
    from ``train.seed`` (rank 0's), and each draw of the global batch's
    shape is made whole and cut to the rank's rows
    (``mesh.global_batch_draws``). With ``inject`` (one (t [B], noise
    [B, Ty, C]) per micro-batch) the step is the deterministic parity
    mode of ``DiffVits.forward`` instead: eval mode on the plain routes
    (no dropout), no posterior or MAS noise, t and noise the rank's rows
    of the given ones."""
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, [], device=device)
    rows_ = mesh.rows(cfg.train.train_batch_size, tr.rank, tr.world)
    local = [batch_rows(mb, rows_) for mb in micro]
    if inject is not None:
        given = iter(inject)
        forward = tr.model.forward

        def parity_forward(*a, generator=None, mas_noise_scale=0.0, **kw):
            t, noise = next(given)
            return forward(*a, t=torch.as_tensor(t[rows_]).to(device),
                           noise=torch.as_tensor(noise[rows_]).to(device),
                           **kw)
        tr.model.forward = parity_forward
        tr.model.eval()
        set_use_fused(tr.model, False)
        metrics = tr.train_step(local)
    else:
        tr.generator.manual_seed(cfg.train.seed)
        with mesh.global_batch_draws(tr.generator, rows_,
                                     cfg.train.train_batch_size):
            metrics = tr.train_step(local)
    params = {n: p.detach().float().cpu().numpy()
              for n, p in tr.model.named_parameters()}
    return params, tr.global_metrics(metrics)


def train_cli(argv: Sequence[str]) -> Tuple[int, List[str]]:
    """``train.cli.main(argv)`` on this rank; returns (the step it reached,
    the checkpoints this rank wrote: rank 0's, none on the others)."""
    from diff_vits_tpu_torch.train import checkpoint, cli
    written: List[str] = []
    save = checkpoint.save_checkpoint

    def recorded(*args, **kwargs):
        path = save(*args, **kwargs)
        written.append(path)
        return path
    checkpoint.save_checkpoint = recorded
    try:
        trainer = cli.main(list(argv))
    finally:
        checkpoint.save_checkpoint = save
    return trainer.step, written


def serve(cfg, state_dict, requests, device: str = "cpu", **kw):
    """``BatchSynthesizer(cfg, state_dict, dp=True, **kw)
    .synthesize_all(requests)`` on this rank (every rank gets every
    result); one process: the single-process run."""
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    syn = BatchSynthesizer(cfg, state_dict, device=device, dp=True, **kw)
    return syn.synthesize_all(requests, seed=0)
