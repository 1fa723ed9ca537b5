"""Checkpoint save/load with keep-newest-N rotation.

Port of ``diff_vits_tpu/train/checkpoint.py:40-83``: ``<dir>/model-<step>.ckpt``
holds the step and the trainer's state (model, optimizer, EMA, random
streams), written with ``torch.save`` to a temporary name and renamed, so
a cut write leaves no half file under the final name. Conversion to and
from the JAX package's msgpack checkpoints is not ported yet.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"model-(\d+)\.ckpt")


def save_checkpoint(path_dir: str, step: int, state: Dict[str, Any],
                    keep: int = 3) -> str:
    """Write ``state`` at ``step``; keep the newest ``keep`` (0: all)."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"model-{step}.ckpt")
    tmp = path + ".tmp"
    torch.save({"step": step, "state": state}, tmp)
    os.replace(tmp, path)
    if keep > 0:
        clean_checkpoints(path_dir, keep)
    return path


def load_checkpoint(path: str, map_location=None) -> Tuple[int, Dict[str, Any]]:
    """(step, state) of a checkpoint this module wrote."""
    data = torch.load(path, map_location=map_location, weights_only=True)
    return int(data["step"]), data["state"]


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
