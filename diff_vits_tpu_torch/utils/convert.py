"""Carry parameters between the JAX package, the PyTorch reference and the
port's modules.

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

``to_flax_params`` walks the other way, port -> flax. A state dict alone
cannot say which layout a leaf had (a Linear weight and an Embedding
weight are both of rank 2), so it walks the modules by type.

``main`` is the reference converter's command line (port of
``diff_vits_tpu/utils/convert.py``): a reference checkpoint, read with
``torch.load(weights_only=True)``, through ``utils/transplant`` and
``from_flax_params`` into the port's params-only checkpoint, which
``Trainer.load`` (the optimizer then restarts, as in JAX) and
``infer.tts_infer`` read.

Usage:
    python -m diff_vits_tpu_torch.utils.convert \
        --ref_ckpt logs/tts/<run>/model-804000.pt \
        -c config.json --out_dir converted/
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diff_vits_tpu_torch.core.config import Config, load_config
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
    ``DiffVits``, for every configuration. Load it with
    ``load_state_dict(..., strict=True)``."""
    check_supported(cfg.vits)
    return convert_tree(flax_params)


# module type -> (the flax name of its ``weight``, the layout change)
_WEIGHT = ((nn.Linear, "kernel", lambda w: w.T),
           (nn.Conv1d, "kernel", lambda w: w.transpose(2, 1, 0)),
           ((nn.LayerNorm, nn.GroupNorm), "scale", lambda w: w),
           (nn.Embedding, "embedding", lambda w: w))


def _flax_leaf(mod: nn.Module, p_name: str, a: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    if p_name == "weight":
        for cls, leaf, layout in _WEIGHT:
            if isinstance(mod, cls):
                return leaf, layout(a)
    return p_name, a


# module type -> the torch dim behind each flax dim of its ``weight``
_PERM = ((nn.Linear, (1, 0)), (nn.Conv1d, (2, 1, 0)))


def flax_leaves(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """Each parameter of ``model`` (by its name in ``named_parameters``) ->
    (its flax path, '/'-joined as JAX's sharding rules read it; the torch
    dim behind each flax dim). The flax shape is ``tuple(p.shape[d] for d
    in dims)``: a Linear weight [out, in] is the kernel [in, out], a
    Conv1d weight [out, in, k] the kernel [k, in, out]; every other leaf
    keeps its layout."""
    out, seen = {}, set()
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            if id(p) in seen:
                continue
            seen.add(id(p))
            leaf, dims = p_name, tuple(range(p.ndim))
            if p_name == "weight":
                leaf = next((name for cls, name, _ in _WEIGHT
                             if isinstance(mod, cls)), leaf)
                dims = next((perm for cls, perm in _PERM
                             if isinstance(mod, cls)), dims)
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            path = mod_name.replace(".", "/")
            out[full] = (f"{path}/{leaf}" if path else leaf, dims)
    return out


def to_flax_params(model: nn.Module,
                   values: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, Any]:
    """The flax params tree of ``model`` (float32 numpy leaves), the inverse
    of :func:`convert_tree`: ``nn.Linear`` weight -> Dense ``kernel``
    [in, out], ``nn.Conv1d`` weight [out, in, k] -> Conv ``kernel``
    [k, in, out] (depthwise included), LayerNorm / GroupNorm weight ->
    ``scale``, ``nn.Embedding`` weight -> ``embedding``, every other
    parameter under its own name. ``values`` (parameter name -> tensor of
    its shape, e.g. an optimizer's moments) stands in for the parameters'
    values. A parameter two module names share is emitted once, under the
    first name ``named_modules`` gives it."""
    tree: Dict[str, Any] = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            v = p if values is None else values[full]
            leaf, a = _flax_leaf(
                mod, p_name, v.detach().to("cpu", torch.float32).numpy())
            node = tree
            for part in mod_name.split(".") if mod_name else ():
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(a)
    return tree


def reference_state_dict_to_port(blob: Any, cfg: Config
                                 ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(step, port ``DiffVits`` state dict) of a reference checkpoint as
    ``torch.load`` returns it (``{'step', 'model': state_dict}`` or a bare
    state dict), through ``utils/transplant`` (model3's modules), tolerating
    DDP / accelerate ``module.`` prefixes."""
    from diff_vits_tpu_torch.utils.transplant import (
        diff_vits_params_from_config)
    step = int(blob.get("step", 0)) if isinstance(blob, dict) else 0
    state = blob["model"] if isinstance(blob, dict) and "model" in blob \
        else blob
    state = {k.removeprefix("module."): v for k, v in state.items()}
    return step, from_flax_params(diff_vits_params_from_config(state, cfg),
                                  cfg)


def main(argv=None) -> str:
    """Convert ``--ref_ckpt`` into ``--out_dir/model-<step>.ckpt`` (params
    only); returns the written path."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ref_ckpt", type=str, required=True,
                        help="reference model-<step>.pt (torch)")
    parser.add_argument("-c", "--config_path", type=str,
                        default="config.json")
    parser.add_argument("--out_dir", type=str, default="converted")
    args = parser.parse_args(argv)

    from diff_vits_tpu_torch.train import checkpoint as ckpt_lib

    cfg = (load_config(args.config_path)
           if os.path.exists(args.config_path) else Config())
    blob = torch.load(args.ref_ckpt, map_location="cpu", weights_only=True)
    step, sd = reference_state_dict_to_port(blob, cfg)
    path = ckpt_lib.save_checkpoint(args.out_dir, step, {"model": sd},
                                    keep=0)
    n = sum(v.numel() for v in sd.values())
    print(f"converted {args.ref_ckpt} (step {step}, {n/1e6:.1f}M params) "
          f"-> {path}")
    return path


if __name__ == "__main__":
    main()
