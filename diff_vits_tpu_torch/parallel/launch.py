"""Parallel training and serving run in spawned processes on one host,
and the checks that the CPU tests and ``chip_smoke.py`` hold to one
process.

:func:`run_ranks` starts ``world`` processes (``spawn``), each a rank of a
process group on ``localhost`` with the backend named, calls
``fn(*args)`` there and returns every rank's result; ``torchrun`` does
the same for real runs. A function sent to the ranks must be importable
(spawned processes unpickle it by its module path), which is why the
checks live here and not in the tests:

* :func:`train_step` runs one ``Trainer`` step on the rank's rows of
  global micro-batches, on any mesh (``train.mesh_axes``; the rank's
  state sharded as ``parallel.sharding`` says) and returns the whole
  parameters after it; :func:`serve` runs ``BatchSynthesizer(dp=True)``;
  :func:`train_cli` the training command line; :func:`checkpoint_cycle`
  loads, steps, saves, exports and resumes a (sharded) ``Trainer``;
  :func:`crash_cycle` makes a sharded step raise on one rank and returns
  what the crash checkpoint holds; :func:`seq_unet` runs a UNet forward
  and backward inside a sequence-parallel scope; :func:`ring` and
  :func:`pipeline` run ``parallel.ring_attention`` and
  ``parallel.pipeline`` with their gradients.
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


def shard_info(tr) -> Dict[str, Any]:
    """What rank ``tr.rank`` holds: its mesh coordinates, the bytes of its
    parameters, AdamW moments and EMA, and each one's shape by parameter
    name (``param``, ``exp_avg``, ``exp_avg_sq``, ``ema``; a moment only
    once the parameter has had a step)."""
    shapes: Dict[str, Dict[str, tuple]] = {}
    for i, (n, p) in enumerate(zip(tr.names, tr.params)):
        st = tr.optimizer.state.get(p, {})
        shapes[n] = dict(param=tuple(p.shape), **{
            k: tuple(st[k].shape) for k in ("exp_avg", "exp_avg_sq")
            if k in st})
        if tr.ema is not None:
            shapes[n]["ema"] = tuple(tr.ema[i].shape)
    return dict(rank=tr.rank, mesh=dict(tr.mesh), coords=tr.layout.coords,
                held_bytes=tr.held_state_bytes(), shapes=shapes,
                sites=[type(m).__name__ for m in tr.plan.sites])


def train_step(cfg, micro: Sequence, device: str = "cpu",
               inject: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]]
               = None, min_size: int = 1 << 16, info: bool = False,
               trainer: Optional[Callable] = None, fsdp_axis: str = "fsdp",
               seq_parallel: bool = False):
    """One ``Trainer(cfg)`` step on this rank's rows of the global
    micro-batches ``micro`` (``train.gradient_accumulate_every`` of them);
    returns (the whole parameters after it by name as float32 arrays,
    gathered from every rank's shards; the metrics averaged over the data
    ranks), and with ``info`` also :func:`shard_info`. ``min_size`` is the
    sharding rules' threshold; ``trainer`` is called with the ``Trainer``
    before the step (to hook it); ``fsdp_axis`` and ``seq_parallel`` are
    the ``Trainer``'s ZeRO-3 axis and ``sequence_parallel``.

    The draws are the single process's: every rank's generator restarts
    from ``train.seed`` (data rank 0's), and each draw of the global
    batch's shape is made whole and cut to the rank's rows
    (``mesh.global_batch_draws``). With ``inject`` (one (t [B], noise
    [B, Ty, C]) per micro-batch) the step is the deterministic parity
    mode of ``DiffVits.forward`` instead: eval mode on the plain routes
    (no dropout), no posterior or MAS noise, t and noise the rank's rows
    of the given ones."""
    from diff_vits_tpu_torch.nn.unet1d import set_use_fused
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, [], device=device, min_size=min_size,
                 fsdp_axis=fsdp_axis, sequence_parallel=seq_parallel)
    if trainer is not None:
        trainer(tr)
    rows_ = mesh.rows(cfg.train.train_batch_size, tr.data_rank,
                      tr.data_ranks)
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
    metrics = tr.global_metrics(metrics)
    whole = tr.whole_state()["model"]
    params = {n: whole[n].detach().float().cpu().numpy() for n in tr.names}
    if info:
        return params, metrics, shard_info(tr)
    return params, metrics


def _array(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` as a numpy array (never a view of a live tensor)."""
    return t.detach().cpu().numpy().copy()


def _numpy_state(whole) -> Dict[str, Any]:
    """A :meth:`Trainer.whole_state` as numpy arrays: params by name,
    moments by "index/key", the EMA by index."""
    opt = {f"{i}/{k}": _array(v)
           for i, st in whole["optimizer"]["state"].items()
           for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")}
    return dict(model={k: _array(v) for k, v in whole["model"].items()},
                optimizer=opt,
                ema=None if whole["ema"] is None
                else [_array(e) for e in whole["ema"]])


def checkpoint_cycle(cfg, batches: Sequence, workdir: str,
                     start: Optional[str] = None, device: str = "cpu",
                     min_size: int = 1 << 16) -> Dict[str, Any]:
    """A (sharded) ``Trainer(cfg)``'s checkpoints on this rank, every rank
    in its own copy of the steps (rows of ``batches``, one a step): load
    ``start`` (a one-process checkpoint) and keep its shards
    (``loaded``: :func:`shard_info` and the whole state gathered from
    them again); one step on
    ``batches[0]``, ``save`` and ``save_flax`` into ``workdir``
    (``whole``: the whole state the files hold; ``eval``: the fixed-t
    losses of the whole model gathered as ``eval_sample`` gathers it, on
    ``batches[0]``); one step on
    ``batches[1]`` (``straight``: the whole parameters after it); then a
    fresh ``Trainer`` that ``resume_latest`` from ``workdir`` (the
    checkpoint just saved) and steps on ``batches[1]`` (``resumed``)."""
    import os
    from diff_vits_tpu_torch.parallel import mesh, sharding
    from diff_vits_tpu_torch.train import checkpoint
    from diff_vits_tpu_torch.train.trainer import Trainer

    def step(tr, batch):
        rows_ = mesh.rows(cfg.train.train_batch_size, tr.data_rank,
                          tr.data_ranks)
        tr.train_step(batch_rows(batch, rows_))

    def whole_params(tr):
        w = tr.whole_state()["model"]
        return {n: _array(w[n]) for n in tr.names}

    out: Dict[str, Any] = {}
    tr = Trainer(cfg, [], device=device, workdir=workdir, min_size=min_size)
    if start is not None:
        tr.load(start)
        out["loaded"] = dict(shard_info(tr),
                             whole=_numpy_state(tr.whole_state()))
    step(tr, batches[0])
    out["saved"] = tr.save(tr.step)
    ema = tr.whole_ema()
    with sharding.whole(tr.model, tr.plan):     # as eval_sample runs it
        out["eval"] = tr.eval_fixed_t_loss(batches[0], ema=ema)
    flax_dir = os.path.join(workdir, "flax")
    tr.logs_folder = flax_dir
    out["saved_flax"] = tr.save_flax(tr.step)
    tr.logs_folder = workdir
    out["whole"] = _numpy_state(tr.whole_state())
    step(tr, batches[1])
    out["straight"] = whole_params(tr)
    resumed = Trainer(cfg, [], device=device, workdir=workdir,
                      min_size=min_size)
    out["resumed_from"] = checkpoint.latest_checkpoint_path(workdir)
    if not resumed.resume_latest() or resumed.step != tr.step - 1:
        raise RuntimeError(f"resume_latest in {workdir} reached step "
                           f"{resumed.step}, not {tr.step - 1}")
    step(resumed, batches[1])
    out["resumed"] = whole_params(resumed)
    return out


def train_cli(argv: Sequence[str], min_size: Optional[int] = None):
    """``train.cli.main(argv)`` on this rank; returns (the step it reached,
    the checkpoints this rank wrote: rank 0's, none on the others). With
    ``min_size`` the ``Trainer`` the command line builds takes it as the
    sharding rules' threshold, and :func:`shard_info` of it comes back
    third."""
    from diff_vits_tpu_torch.train import checkpoint, cli
    from diff_vits_tpu_torch.train import trainer as trainer_lib
    written: List[str] = []
    save, cls = checkpoint.save_checkpoint, trainer_lib.Trainer

    def recorded(*args, **kwargs):
        path = save(*args, **kwargs)
        written.append(path)
        return path

    class Sized(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, min_size=min_size, **kwargs)
    checkpoint.save_checkpoint = recorded
    if min_size is not None:
        trainer_lib.Trainer = Sized
    try:
        trainer = cli.main(list(argv))
    finally:
        checkpoint.save_checkpoint, trainer_lib.Trainer = save, cls
    if min_size is None:
        return trainer.step, written
    return trainer.step, written, shard_info(trainer)


def serve(cfg, state_dict, requests, device: str = "cpu", **kw):
    """``BatchSynthesizer(cfg, state_dict, dp=True, **kw)
    .synthesize_all(requests)`` on this rank (every rank gets every
    result); one process: the single-process run."""
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    syn = BatchSynthesizer(cfg, state_dict, device=device, dp=True, **kw)
    return syn.synthesize_all(requests, seed=0)


def crash_cycle(cfg, batches: Sequence, workdir: str, fail_rank: int,
                device: str = "cpu", min_size: int = 1 << 16
                ) -> Dict[str, Any]:
    """A sharded ``Trainer(cfg)`` on this rank: one step on ``batches[0]``
    (``before``: the whole state after it, as :func:`_numpy_state`), then
    ``train`` on ``batches[1]``, whose step raises on rank ``fail_rank``
    before its first collective; the other ranks fail in theirs once that
    rank has gone. ``error``: the exception ``train`` raised on this rank
    (``repr``); ``crash``: the crash checkpoint's path the rank wrote."""
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, [], device=device, workdir=workdir, min_size=min_size)
    rows_ = mesh.rows(cfg.train.train_batch_size, tr.data_rank,
                      tr.data_ranks)
    tr.train_step(batch_rows(batches[0], rows_))
    before = _numpy_state(tr.whole_state())
    tr.batches = [batch_rows(batches[1], rows_)]
    written: List[str] = []
    step_on, save = tr.step_on, tr.save

    def failing(micro):
        if tr.rank == fail_rank:
            raise RuntimeError(f"injected failure on rank {tr.rank}")
        return step_on(micro)

    def recorded(step, sync=True):
        path = save(step, sync)
        written.append(path)
        return path
    tr.step_on, tr.save = failing, recorded
    try:
        tr.train(num_steps=2, prefetch=False)
        error = None
    except Exception as e:  # the test reads what each rank raised
        error = repr(e)
    return dict(before=before, error=error, crash=written, step=tr.step)


def seq_unet(state_dict, kwargs, inputs, weights: np.ndarray,
             train: bool, mesh_axes: Sequence[str] = ("seq",),
             mesh_shape: Optional[Sequence[int]] = None,
             device: str = "cpu") -> Dict[str, np.ndarray]:
    """``UNet1DConditionModel(**kwargs)`` with ``state_dict`` in train or
    eval mode, on ``inputs`` (sample, timestep, context, context keep
    mask) inside ``activations.sequence_parallel`` of the mesh
    (``mesh_axes``; one process: no scope): ``out`` the whole output
    (every rank's frames gathered), and the gradients of
    sum(out * ``weights``) for the parameters (``grads``, summed over the
    ``seq`` ranks: each holds its frames' share) and the sample
    (``dx``)."""
    from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
    from diff_vits_tpu_torch.parallel import activations, mesh, sharding
    model = UNet1DConditionModel(device=device, **kwargs)
    model.load_state_dict(state_dict)
    model.train(train)
    x, t, ctx, keep = (torch.as_tensor(np.asarray(a)).to(device)
                       for a in inputs)
    x.requires_grad_(True)
    layout = None
    if mesh.distributed():
        layout = sharding.Layout(
            mesh.make_mesh(mesh_shape, mesh_axes), mesh.rank())
    with activations.sequence_parallel(layout):
        y = model(x, t, ctx, keep)
        levels = len(model.block_out_channels)
        seq = activations.shard(x.shape[1], levels)
        w = activations.constrain_seq(torch.as_tensor(weights).to(device),
                                      align=2 ** (levels - 1))
        (y * w).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    dx = x.grad
    if seq is not None:
        y = seq.gather(y)
        grads = {n: seq.all_reduce(g) for n, g in grads.items()}
        dx = seq.all_reduce(dx)
    return dict(out=_array(y), dx=_array(dx),
                grads={n: _array(g) for n, g in grads.items()})


def ring(q, k, v, keep, axis: str = "seq") -> Dict[str, Any]:
    """``make_ring_attention`` over every rank (a mesh of one ``axis``)
    on the whole q, k, v [B, H, T, d] and keep mask: the output and the
    gradients of sum(out^2) for q, k and v."""
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.parallel.ring_attention import (
        make_ring_attention)
    q, k, v = (torch.as_tensor(np.asarray(a)).requires_grad_(True)
               for a in (q, k, v))
    fn = make_ring_attention(mesh.make_mesh(None, (axis,)), axis)
    out = fn(q, k, v, None if keep is None else torch.as_tensor(keep))
    (out ** 2).sum().backward()
    return dict(out=_array(out), grads=[_array(a.grad) for a in (q, k, v)])


def tanh_layer(p, x):
    """The layer of JAX's pipeline tests: tanh(x @ w + b)."""
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline(params, x, n_micro: int, layer: Callable = tanh_layer
             ) -> Dict[str, Any]:
    """``make_pipeline(layer, ...)`` over every rank (a ``stage`` mesh)
    on the whole stacked ``params`` and ``x``: the output and the
    gradients of sum(out^2) for every parameter and for x; or the
    ValueError's message it raised."""
    from diff_vits_tpu_torch.parallel import mesh
    from diff_vits_tpu_torch.parallel.pipeline import make_pipeline
    p = {k: torch.as_tensor(np.asarray(v)).requires_grad_(True)
         for k, v in params.items()}
    x = torch.as_tensor(np.asarray(x)).requires_grad_(True)
    fn = make_pipeline(layer, mesh.make_mesh(None, ("stage",)), n_micro)
    try:
        out = fn(p, x)
    except ValueError as e:
        return dict(error=str(e))
    (out ** 2).sum().backward()
    return dict(out=_array(out), dx=_array(x.grad),
                grads={k: _array(v.grad) for k, v in p.items()})
