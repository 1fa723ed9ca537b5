"""Checkpoint save/load with keep-newest-N rotation.

Port of ``diff_vits_tpu/train/checkpoint.py:40-83``: ``<dir>/model-<step>.ckpt``
holds the step and the trainer's state (model, optimizer, EMA, random
streams), written with ``torch.save`` to a temporary name and renamed, so
a cut write leaves no half file under the final name.

``save_flax_checkpoint`` writes the JAX package's format instead (a flax
msgpack map ``{"step", "state"}`` through ``utils/msgpack_ckpt.pack``, no
flax needed), which its ``load_checkpoint`` reads. ``load_checkpoint``
reads both formats, telling them apart by their first bytes;
``load_model_state_dict`` takes the port ``DiffVits`` state dict out of
either.

A sharded trainer whose step raised writes without a collective:
``save_shard_checkpoint`` puts each rank's own shards and its place in the
sharding (``<dir>/model-<step>.shards/rank-<r>-of-<world>.pt``), and
``load_checkpoint`` of that directory reassembles the whole state from
every rank's file, as one process holds it (``load_shard_checkpoint``).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from diff_vits_tpu_torch.utils import msgpack_ckpt
from diff_vits_tpu_torch.utils.convert import from_flax_params

_NAME = re.compile(r"model-(\d+)\.(ckpt|shards)")
_RANK = re.compile(r"rank-(\d+)-of-(\d+)\.pt")


def _commit(path_dir: str, step: int, write: Callable[[str], None],
            keep: int) -> str:
    """``write`` ``<path_dir>/model-<step>.ckpt`` under a temporary name,
    rename it, keep the newest ``keep`` (0: all); returns the path."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"model-{step}.ckpt")
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)
    if keep > 0:
        clean_checkpoints(path_dir, keep)
    return path


def save_checkpoint(path_dir: str, step: int, state: Dict[str, Any],
                    keep: int = 3) -> str:
    """Write ``state`` at ``step``; keep the newest ``keep`` (0: all)."""
    return _commit(path_dir, step,
                   lambda tmp: torch.save({"step": step, "state": state}, tmp),
                   keep)


def _device_got(tree):
    """``tree`` as ``jax.device_get`` hands it to the JAX package's writer:
    numpy scalars become 0-d arrays."""
    if isinstance(tree, dict):
        return {k: _device_got(v) for k, v in tree.items()}
    return np.asarray(tree) if isinstance(tree, np.generic) else tree


def save_flax_checkpoint(path_dir: str, step: int, state: Dict[str, Any],
                         keep: int = 3) -> str:
    """Write ``{"step": np.asarray(step), "state": state}`` (a tree of dicts
    over numpy / torch leaves) as the JAX package's ``save_checkpoint``
    does (diff_vits_tpu/train/checkpoint.py:40-54), byte for byte: flax
    msgpack, to a temporary name then renamed; keep the newest ``keep``
    (0: all)."""
    blob = msgpack_ckpt.pack({"step": np.asarray(step),
                              "state": _device_got(state)})

    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(blob)
    return _commit(path_dir, step, write, keep)


def save_shard_checkpoint(path_dir: str, step: int, rank: int, world: int,
                          state: Dict[str, Any],
                          layout: Dict[str, Any]) -> str:
    """Rank ``rank`` of ``world``'s own ``state`` (a sharded trainer's:
    ``model``, ``optimizer`` and ``ema`` hold its shards) and ``layout``
    (``mesh``, ``coords``, ``names``: the parameters in the optimizer's
    order, ``leaves``: each split parameter's whole ``shape``, the torch
    ``dims`` each axis splits and its ``parts``) as
    ``<path_dir>/model-<step>.shards/rank-<rank>-of-<world>.pt``, under a
    temporary name then renamed. No collective: every rank writes alone."""
    folder = os.path.join(path_dir, f"model-{step}.shards")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"rank-{rank}-of-{world}.pt")
    torch.save({"step": step, "rank": rank, "world": world,
                "layout": layout, "state": state}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _rank_files(folder: str) -> Dict[int, str]:
    """rank -> file of a ``.shards`` directory when it holds every rank's
    file, else {}."""
    found = {}
    world = None
    for name in os.listdir(folder):
        m = _RANK.fullmatch(name)
        if m:
            found[int(m.group(1))] = os.path.join(folder, name)
            world = int(m.group(2))
    return found if world is not None and sorted(found) == list(
        range(world)) else {}


def _assemble(leaf: Mapping[str, Any], mesh: Mapping[str, int],
              shards) -> torch.Tensor:
    """A split parameter's whole tensor from (coords, shard) of ranks that
    together hold every block (``parallel.sharding.block``'s layout)."""
    from diff_vits_tpu_torch.parallel.sharding import block
    shape = tuple(leaf["shape"])
    whole = torch.empty(shape, dtype=shards[0][1].dtype)
    index = torch.arange(whole.numel()).view(shape)
    for coords, t in shards:
        sub = index
        for a, d in leaf["dims"].items():
            sub = block(sub, d, coords[a], mesh[a],
                        leaf["parts"] if a == "model" else 1)
        whole.view(-1)[sub.reshape(-1)] = t.reshape(-1)
    return whole


def load_shard_checkpoint(folder: str, map_location=None
                          ) -> Tuple[int, Dict[str, Any]]:
    """(step, whole state) of a ``.shards`` directory: every rank's file
    read and each split parameter, AdamW moment and EMA entry reassembled;
    the rest (buffers, the optimizer's step and groups, the Python coin's
    state) as rank 0 holds it; ``generator`` rank 0's, ``generators``
    every rank's. The state :meth:`Trainer.save` writes, on
    ``map_location``. ValueError when a rank's file is missing."""
    files = _rank_files(folder)
    if not files:
        raise ValueError(f"{folder}: not every rank's shard file is there")
    data = [torch.load(files[r], map_location="cpu", weights_only=False)
            for r in sorted(files)]
    lay = data[0]["layout"]
    mesh, names, leaves = lay["mesh"], lay["names"], lay["leaves"]
    states = [d["state"] for d in data]
    coords = [d["layout"]["coords"] for d in data]

    def whole(name, pick):
        return _assemble(leaves[name], mesh,
                         [(c, pick(st)) for c, st in zip(coords, states)])

    dev = map_location
    model = {k: whole(k, lambda st: st["model"][k]) if k in leaves else v
             for k, v in states[0]["model"].items()}
    opt = states[0]["optimizer"]
    for i, n in enumerate(names):
        st = opt["state"].get(i)
        if st is None or n not in leaves:
            continue
        opt["state"][i] = dict(st, **{
            key: whole(n, lambda s, key=key: s["optimizer"]["state"][i][key])
            for key in ("exp_avg", "exp_avg_sq") if key in st})
    state = {"model": {k: v.to(dev) for k, v in model.items()},
             "optimizer": opt,
             "generator": states[0]["generator"],
             "generators": torch.stack([st["generator"] for st in states]),
             "py_rng": states[0]["py_rng"]}
    if states[0].get("ema") is not None:
        state["ema"] = [(whole(n, lambda st, j=j: st["ema"][j])
                         if n in leaves else e).to(dev)
                        for j, (n, e) in enumerate(zip(names,
                                                       states[0]["ema"]))]
    return int(data[0]["step"]), state


def load_checkpoint(path: str, map_location=None) -> Tuple[int, Dict[str, Any]]:
    """(step, state) of a checkpoint this module wrote (a ``torch.save``
    zip, or a ``.shards`` directory: :func:`load_shard_checkpoint`) or of
    one the JAX package wrote (a flax msgpack map; its state is the saved
    tree, numpy leaves and ``torch.bfloat16`` tensors, on the CPU). Any
    other file is refused."""
    if os.path.isdir(path):
        return load_shard_checkpoint(path, map_location)
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        data = torch.load(path, map_location=map_location, weights_only=True)
        return int(data["step"]), data["state"]
    if msgpack_ckpt.is_msgpack_map(head):
        return msgpack_ckpt.read_flax_checkpoint(path)
    raise ValueError(f"{path}: neither a torch.save checkpoint nor a flax "
                     f"msgpack one (starts with {head!r})")


def load_model_state_dict(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The port ``DiffVits`` state dict of a checkpoint at ``path``: the
    port's own (``state["model"]``) or a JAX trainer state's flax
    parameters (``state["params"]``, through ``from_flax_params``), on the
    CPU."""
    _, state = load_checkpoint(path, map_location="cpu")
    if "model" in state:
        return state["model"]
    if "params" in state:
        return from_flax_params(state["params"], cfg)
    raise ValueError(f"{path}: the checkpoint holds neither 'model' (the "
                     "port's) nor 'params' (the JAX package's)")


def _list_ckpts(path_dir: str) -> List[Tuple[int, str]]:
    """(step, path) of the checkpoints in ``path_dir``, oldest first: the
    files and the complete ``.shards`` directories, a file after a
    directory of its step."""
    if not os.path.isdir(path_dir):
        return []
    found = []
    for name in os.listdir(path_dir):
        m = _NAME.fullmatch(name)
        path = os.path.join(path_dir, name)
        if m and (m.group(2) == "ckpt" or _rank_files(path)):
            found.append((int(m.group(1)), m.group(2) == "ckpt", path))
    return [(step, path) for step, _, path in sorted(found)]


def latest_checkpoint_path(path_dir: str) -> Optional[str]:
    ckpts = _list_ckpts(path_dir)
    return ckpts[-1][1] if ckpts else None


def clean_checkpoints(path_dir: str, n_ckpts_to_keep: int = 3) -> None:
    """Delete all but the newest ``n_ckpts_to_keep`` by step number."""
    for _, path in _list_ckpts(path_dir)[:-n_ckpts_to_keep]:
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
