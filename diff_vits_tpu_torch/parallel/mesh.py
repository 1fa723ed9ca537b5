"""The mesh of the port on ``torch.distributed``, and the sharding rules.

Port of ``diff_vits_tpu/parallel/mesh.py``. JAX declares mesh axes and
lets GSPMD insert the collectives; here every rank is one process
(``torchrun`` starts them) at one point of the mesh, and the collectives
are explicit (``parallel/sharding.py``):

* :func:`init_distributed` joins the process group that torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` describe (a no-op without ``RANK``), with NCCL for the
  card and gloo for the CPU unless told otherwise, and prints the choice;
* :func:`make_mesh` keeps JAX's rule: a ``mesh_shape`` whose product is
  not the world size becomes ``(world,) + (1,) * ...``. It takes the axes
  JAX's ``Trainer`` takes (:data:`AXES`) and refuses any other name. Rank
  r sits at ``np.unravel_index(r, shape)``, as ``create_device_mesh``
  lays out a host's devices. Rows of a global batch go over
  :data:`DATA_AXES` (``data``, and ``fsdp``, ZeRO-3's data-parallel
  axis); ranks that differ only on ``model``, ``expert``, ``seq`` or
  ``stage`` take the same rows (:func:`data_index`). ``seq`` shards the
  diffusion UNet's frames inside a ``parallel.activations`` scope (else
  its ranks are replicas); ``stage`` is ``parallel.pipeline``'s, which
  ``Trainer`` refuses, as JAX's does;
* :func:`state_sharding_rules` (and ``parallel/moe.py``'s
  ``expert_sharding_rules``) are JAX's rules as pure functions over flax
  paths and flax-layout shapes (``utils.convert.flax_leaves`` gives them
  for the port's parameters): Megatron column / row tensor parallelism
  over ``model``, ZeRO-3 scattering of large kernels over ``fsdp`` and
  the MoE expert kernels over ``expert`` (else ``model``). A spec is a
  tuple with one entry per flax dimension: the axis that splits it, or
  None;
* :func:`rows` is a data rank's row range of a global batch, and
  :class:`global_batch_draws` makes a rank's random draws the rows of the
  global batch's draws (data-parallel serving draws the noise of one
  process that way);
* the world collectives (:func:`all_reduce_sum`, :func:`all_gather_rows`,
  :func:`barrier`) take tensors on any device: under gloo a CUDA tensor
  goes through the host, since gloo reduces host memory.

Without a process group the world is one rank, rank 0, and every
collective is the identity; under one (even of one rank, as a one-card
torchrun gives) the collectives run.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

AXES = ("data", "fsdp", "model", "expert", "seq", "stage")
DATA_AXES = ("data", "fsdp")
Spec = Tuple[Optional[str], ...]


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
    Refuses an axis that is not one of :data:`AXES`, or named twice."""
    n = world_size() if world is None else world
    axis_names = tuple(axis_names)
    unknown = [a for a in axis_names if a not in AXES]
    if unknown or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names}: each must be one of "
                         f"{AXES}, once")
    if mesh_shape is None or math.prod(mesh_shape) != n:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    return dict(zip(axis_names, (int(s) for s in mesh_shape)))


def coords(mesh: Mapping[str, int], rank_: int) -> Dict[str, int]:
    """Rank ``rank_``'s coordinate on each axis of ``mesh`` (row-major)."""
    at = np.unravel_index(rank_, tuple(mesh.values())) if mesh else ()
    return {a: int(c) for a, c in zip(mesh, at)}


def data_size(mesh: Mapping[str, int]) -> int:
    """The number of data-parallel ranks: the product of the
    :data:`DATA_AXES` sizes."""
    return math.prod(mesh.get(a, 1) for a in DATA_AXES)


def data_index(mesh: Mapping[str, int], rank_: int) -> int:
    """Rank ``rank_``'s data coordinate: which of the :func:`data_size`
    row blocks of a global batch it takes (``data`` major, ``fsdp``
    minor)."""
    c = coords(mesh, rank_)
    axes = [a for a in mesh if a in DATA_AXES]
    if not axes:
        return 0
    return int(np.ravel_multi_index([c[a] for a in axes],
                                    [mesh[a] for a in axes]))


# Megatron-style tensor parallelism by parameter path (JAX's lists). A
# "column" kernel splits its output features over 'model'; the matching
# "row" kernel its input features, and one all-reduce completes the block.
_COLUMN_HINTS = ("to_q", "to_k", "to_v", "in_proj", "w_q", "w_k", "w_v",
                 "ffn_1", "ff/proj", "pwconv1", "query", "key", "value")
_ROW_HINTS = ("to_out", "out_proj", "ffn_2", "ff/out", "pwconv2", "fc")


def tp_spec(path: str, shape: Sequence[int], model_size: int,
            min_size: int, fsdp_size: int = 1,
            fsdp_axis: str = "fsdp") -> Spec:
    """JAX's ``_tp_spec`` on the flax path ``path`` ('/'-joined) of a leaf
    of flax-layout ``shape``: replicated below 2 dimensions or
    ``min_size`` elements; else a column kernel splits dim -1 and a row
    kernel dim -2 over ``model``, when divisible; then ZeRO-3 puts
    ``fsdp_axis`` on the first of dims -2, -1 that is free and
    divisible."""
    spec: List[Optional[str]] = [None] * len(shape)
    if len(shape) < 2 or math.prod(shape) < min_size:
        return tuple(spec)
    if model_size > 1:
        if any(h in path for h in _COLUMN_HINTS) and \
                shape[-1] % model_size == 0:
            spec[-1] = "model"
        elif any(h in path for h in _ROW_HINTS) and \
                shape[-2] % model_size == 0:
            spec[-2] = "model"
    if fsdp_size > 1:
        for dim in (-2, -1):
            if spec[dim] is None and shape[dim] % fsdp_size == 0:
                spec[dim] = fsdp_axis
                break
    return tuple(spec)


def state_sharding_rules(mesh: Mapping[str, int],
                         leaves: Mapping[str, Sequence[int]],
                         min_size: int = 1 << 16,
                         fsdp_axis: str = "fsdp") -> Dict[str, Spec]:
    """JAX's ``state_sharding_rules`` over ``leaves`` (flax path -> flax
    shape): each leaf's spec. The AdamW moments and the EMA of a parameter
    take the parameter's spec (JAX's hints match the moment's path, of
    which the parameter's is a suffix). MoE expert leaves (``w1``, ``b1``,
    ``w2``, ``b2`` under ``ff_moe``) split their leading expert dim over
    ``expert`` when that axis exceeds 1, else over ``model``."""
    model_size = mesh.get("model", 1)
    fsdp_size = mesh.get(fsdp_axis, 1)
    ep_axis = "expert" if mesh.get("expert", 1) > 1 else "model"
    ep_size = mesh.get(ep_axis, 1)
    out = {}
    for path, shape in leaves.items():
        shape = tuple(shape)
        if "ff_moe" in path and ep_size > 1 and len(shape) >= 2 and \
                path.rsplit("/", 1)[-1] in ("w1", "w2", "b1", "b2") and \
                shape[0] % ep_size == 0:
            out[path] = (ep_axis,) + (None,) * (len(shape) - 1)
        else:
            out[path] = tp_spec(path, shape, model_size, min_size,
                                fsdp_size, fsdp_axis)
    return out


def rows(batch_size: int, rank_: int, world: int) -> slice:
    """The rows of a global batch of ``batch_size`` that data rank
    ``rank_`` of ``world`` takes; ValueError unless ``world`` divides
    it."""
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
