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
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from diff_vits_tpu_torch.utils import msgpack_ckpt
from diff_vits_tpu_torch.utils.convert import from_flax_params

_NAME = re.compile(r"model-(\d+)\.ckpt")


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


def load_checkpoint(path: str, map_location=None) -> Tuple[int, Dict[str, Any]]:
    """(step, state) of a checkpoint this module wrote (a ``torch.save``
    zip) or of one the JAX package wrote (a flax msgpack map; its state is
    the saved tree, numpy leaves and ``torch.bfloat16`` tensors, on the
    CPU). Any other file is refused."""
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
    if not os.path.isdir(path_dir):
        return []
    return sorted((int(m.group(1)), os.path.join(path_dir, name))
                  for name in os.listdir(path_dir)
                  if (m := _NAME.fullmatch(name)))


def latest_checkpoint_path(path_dir: str) -> Optional[str]:
    ckpts = _list_ckpts(path_dir)
    return ckpts[-1][1] if ckpts else None


def clean_checkpoints(path_dir: str, n_ckpts_to_keep: int = 3) -> None:
    """Delete all but the newest ``n_ckpts_to_keep`` by step number."""
    for _, path in _list_ckpts(path_dir)[:-n_ckpts_to_keep]:
        os.remove(path)
