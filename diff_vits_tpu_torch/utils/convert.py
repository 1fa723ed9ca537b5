"""Carry the JAX package's parameters into the port's modules.

The port names its submodules after the flax tree (``vits.enc_p.emb``,
``diff_model.unet.down_0.attn_0.block_0.attn2.to_q``, ...), so the walk is
mechanical:

  Dense kernel [in, out]       -> Linear weight [out, in]
  Conv kernel [k, in, out]     -> Conv1d weight [out, in, k]
  LayerNorm/GroupNorm scale    -> weight
  Embed embedding              -> weight
  bias and named parameters    -> unchanged (positional_embedding,
                                  emb_rel_k, emb_rel_v, m, logs)

(a depthwise Conv kernel [k, 1, C] becomes the grouped Conv1d weight
[C, 1, k] by the same rule).

Every leaf is converted, the training-only posterior encoder
(``vits.enc_q``) included. A tree of gradients has the parameters' names
and shapes, so it converts the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.models.vits import check_supported


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        elif isinstance(v, torch.Tensor):   # bfloat16 leaves of a checkpoint
            yield path, v.float().numpy()
        else:
            yield path, np.asarray(v)


def _convert(path: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    parent, _, leaf = path.rpartition(".")
    weight = f"{parent}.weight" if parent else "weight"
    if leaf == "kernel":
        if a.ndim == 2:
            return weight, a.T
        if a.ndim == 3:
            return weight, a.transpose(2, 1, 0)
        raise ValueError(f"{path}: kernel of rank {a.ndim}")
    if leaf in ("scale", "embedding"):
        return weight, a
    return path, a


def convert_tree(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any flax params tree of a module the port mirrors (numpy leaves, or
    torch tensors as ``utils.msgpack_ckpt`` reads bfloat16 ones) -> that
    module's float32 ``state_dict``."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(flax_params):
        name, v = _convert(path, a)
        out[name] = torch.tensor(np.ascontiguousarray(v, np.float32))
    return out


def from_flax_params(flax_params: Mapping[str, Any], cfg: Config
                     ) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree of ``DiffVits`` (numpy leaves; with or without
    the outer ``{"params": ...}``) -> ``state_dict`` of the port's
    ``DiffVits``, for every configuration the port builds (all but the
    phoneme VAE). Load it with ``load_state_dict(..., strict=True)``."""
    check_supported(cfg.vits)
    return convert_tree(flax_params)
