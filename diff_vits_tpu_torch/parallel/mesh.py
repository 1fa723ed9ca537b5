"""Data parallelism of the port on ``torch.distributed``.

Port of the data-parallel part of ``diff_vits_tpu/parallel/mesh.py:20-52``.
JAX declares a ``data`` mesh axis and lets GSPMD insert the collectives;
here every rank is one process (``torchrun`` starts them), holds the whole
model, takes its rows of each global batch and joins explicit collectives:

* :func:`init_distributed` joins the process group that torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` describe (a no-op without ``RANK``), with NCCL for the
  card and gloo for the CPU unless told otherwise, and prints the choice;
* :func:`make_mesh` keeps JAX's rule: a ``mesh_shape`` whose product is
  not the world size becomes ``(world,) + (1,) * ...``; an axis other than
  ``data`` larger than 1 (tensor, expert or sequence parallelism, ROADMAP
  Queue 1 item 7) is refused;
* :func:`rows` is the rank's row range of a global batch, and
  :class:`global_batch_draws` makes a rank's random draws the rows of the
  global batch's draws (data-parallel serving draws the noise of one
  process that way);
* the collectives (:func:`all_reduce_sum`, :func:`all_gather_rows`,
  :func:`barrier`) take tensors on any device: under gloo a CUDA tensor
  goes through the host, since gloo reduces host memory.

Without a process group the world is one rank, rank 0, and every
collective is the identity; under one (even of one rank, as a one-card
torchrun gives) the collectives run.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

MODEL_AXES = ("model", "expert", "seq")


def init_distributed(backend: Optional[str] = None,
                     device: Optional[str] = None) -> bool:
    """Join torchrun's process group when its ``RANK`` is set; False when it
    is not (one process). ``backend`` defaults to "gloo" when ``device``
    is a CPU device and to "nccl" otherwise; under NCCL the rank's card is
    ``cuda:LOCAL_RANK``. Prints the backend, rank and world size."""
    if "RANK" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, rank=rank, world_size=world)
    print(f"torch.distributed: backend {backend}, rank {rank} of {world} "
          f"(local rank {os.environ.get('LOCAL_RANK', 0)})", flush=True)
    return True


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              world: Optional[int] = None) -> Dict[str, int]:
    """The mesh as {axis name: size} over ``world`` ranks (default: the
    process group's size). As JAX's ``make_mesh``, a shape whose product is
    not the world size is replaced by ``(world,) + (1,) * (len(axes) - 1)``.
    Refuses an axis of :data:`MODEL_AXES` larger than 1."""
    n = world_size() if world is None else world
    axis_names = tuple(axis_names)
    if mesh_shape is None or math.prod(mesh_shape) != n:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh = dict(zip(axis_names, (int(s) for s in mesh_shape)))
    wide = {a: s for a, s in mesh.items() if a in MODEL_AXES and s > 1}
    if wide:
        raise ValueError(
            f"mesh {mesh}: the port runs data parallelism only; the axes "
            f"{sorted(wide)} (tensor, expert or sequence parallelism) wait "
            "for ROADMAP Queue 1, item 7")
    return mesh


def rows(batch_size: int, rank_: int, world: int) -> slice:
    """The rows of a global batch of ``batch_size`` that rank ``rank_`` of
    ``world`` takes; ValueError unless ``world`` divides it."""
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} must be divisible by the "
                         f"{world} data-parallel ranks: each takes an equal "
                         "share of every batch")
    n = batch_size // world
    return slice(rank_ * n, (rank_ + 1) * n)


_DRAWS = (torch.rand, torch.randn, torch.randint)


class global_batch_draws(TorchFunctionMode):
    """Inside the block, every ``torch.rand`` / ``randn`` / ``randint`` that
    draws from ``generator`` a tensor whose first dimension is the rank's
    rows ``rows`` of a global batch of ``batch`` draws the global batch's
    tensor instead and keeps those rows. A rank then draws what one process
    running the whole batch from the same generator draws for these rows
    (every draw of the port's models is batch-first). A draw of another
    first dimension from ``generator`` raises; draws from other
    generators are untouched."""

    def __init__(self, generator: torch.Generator, rows_: slice,
                 batch: int):
        super().__init__()
        self.generator, self.rows, self.batch = generator, rows_, batch
        self.local = rows_.stop - rows_.start

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DRAWS or kwargs.get("generator") is not self.generator:
            return func(*args, **kwargs)
        # rand / randn (size) or (*size); randint (high, size) or
        # (low, high, size)
        if func is torch.randint:
            head, size = args[:-1], tuple(args[-1])
        elif len(args) == 1 and not isinstance(args[0], int):
            head, size = (), tuple(args[0])
        else:
            head, size = (), tuple(args)
        if not size or size[0] != self.local:
            raise ValueError(
                f"{func.__name__} of size {size} from the rows' generator: "
                f"the first dimension is not the {self.local} rows")
        full = func(*head, (self.batch,) + size[1:], **kwargs)
        return full[self.rows].contiguous()


def _via_host() -> bool:
    return dist.get_backend() == "gloo"


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor on ``t``'s device; no
    gradient). ``t`` itself without a process group."""
    if not distributed():
        return t
    buf = t.detach().to("cpu" if _via_host() else t.device, copy=True)
    dist.all_reduce(buf)
    return buf.to(t.device)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (each the same shape) concatenated along dim 0 in
    rank order; ``t`` without a process group."""
    if not distributed():
        return t
    world = world_size()
    where = "cpu" if _via_host() else t.device
    buf = t.detach().to(where).contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(t.device)


def barrier() -> None:
    if distributed():
        dist.barrier()


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
