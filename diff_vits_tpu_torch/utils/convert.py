"""Carry parameters between the JAX package, the PyTorch reference and the
port's modules.

The port names its submodules after the flax tree (``vits.enc_p.emb``,
``diff_model.unet.down_0.attn_0.block_0.attn2.to_q``, ...), so the walk is
mechanical:

  Dense kernel [in, out]       -> Linear weight [out, in]
  Conv kernel [k, in, out]     -> Conv1d weight [out, in, k]
  Conv kernel [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]
  LayerNorm/GroupNorm scale    -> weight
  Embed embedding              -> weight
  bias and named parameters    -> unchanged (positional_embedding,
                                  emb_rel_k, emb_rel_v, m, logs, tao,
                                  GaussianFourierProjection's weight)

(a depthwise Conv kernel [k, 1, C] becomes the grouped Conv1d weight
[C, 1, k] by the same rule; LoRA's ``down`` / ``up`` adapters are Dense
or Conv leaves like any other).

A recurrent cell, a node whose children are its per-gate denses, becomes
one layer of a ``torch.nn.GRU`` / ``LSTM`` (the module of the cell's
name; a pair ``X_fwd`` / ``X_bwd`` is the bidirectional module ``X``, the
second direction's tensors ``*_l0_reverse``):

  GRUCell  ir iz in (biased), hr hz (unbiased), hn (biased)
           -> weight_ih_l0 [ir; iz; in], weight_hh_l0 [hr; hz; hn],
              bias_ih_l0 [b_ir; b_iz; b_in], bias_hh_l0 [0; 0; b_hn]
              (torch's r multiplies W_hn h + b_hn, as flax's does)
  OptimizedLSTMCell  ii if ig io (unbiased), hi hf hg ho (biased)
           -> weight_ih_l0 [ii; if; ig; io], weight_hh_l0 [hi; hf; hg; ho],
              bias_ih_l0 0, bias_hh_l0 [b_hi; b_hf; b_hg; b_ho]

``to_flax_params`` folds each bias_ih part into the flax bias of its gate
(a zero part adds nothing, so a converted tree comes back bit for bit).

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


# torch's gate order; flax's per-gate dense names
_GRU_INPUT, _GRU_HIDDEN = ("ir", "iz", "in"), ("hr", "hz", "hn")
_LSTM_INPUT, _LSTM_HIDDEN = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")


def _cell_kind(node: Mapping[str, Any]) -> Optional[str]:
    keys = set(node)
    if keys == set(_GRU_INPUT + _GRU_HIDDEN):
        return "gru"
    if keys == set(_LSTM_INPUT + _LSTM_HIDDEN):
        return "lstm"
    return None


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):         # bfloat16 leaves of a checkpoint
        return v.float().numpy()
    return np.asarray(v)


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(path, leaf) of every leaf, and (path, node) of every recurrent
    cell."""
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping) and _cell_kind(v) is None:
            yield from _flatten(v, path)
        elif isinstance(v, Mapping):
            yield path, v
        else:
            yield path, _np(v)


def _rnn_names(path: str) -> Tuple[str, str]:
    """A cell's path -> (its torch module, the parameter suffix)."""
    for flax_end, suffix in (("_fwd", "_l0"), ("_bwd", "_l0_reverse")):
        if path.endswith(flax_end):
            return path[:-len(flax_end)], suffix
    return path, "_l0"


def _pack_cell(path: str, cell: Mapping[str, Any]):
    """(torch name, value) of a recurrent cell's packed tensors."""
    mod, sfx = _rnn_names(path)
    if _cell_kind(cell) == "gru":
        ins, hids = _GRU_INPUT, _GRU_HIDDEN
    else:
        ins, hids = _LSTM_INPUT, _LSTM_HIDDEN

    def kernels(names):
        return np.concatenate([_np(cell[n]["kernel"]).T for n in names])

    def biases(names):
        return np.concatenate([
            _np(cell[n]["bias"]) if "bias" in cell[n]
            else np.zeros(_np(cell[n]["kernel"]).shape[1], np.float32)
            for n in names])
    yield f"{mod}.weight_ih{sfx}", kernels(ins)
    yield f"{mod}.weight_hh{sfx}", kernels(hids)
    yield f"{mod}.bias_ih{sfx}", biases(ins)
    yield f"{mod}.bias_hh{sfx}", biases(hids)


def _convert(path: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    parent, _, leaf = path.rpartition(".")
    weight = f"{parent}.weight" if parent else "weight"
    if leaf == "kernel":
        if a.ndim == 2:
            return weight, a.T
        if a.ndim == 3:
            return weight, a.transpose(2, 1, 0)
        if a.ndim == 4:
            return weight, a.transpose(3, 2, 0, 1)
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
        pairs = _pack_cell(path, a) if isinstance(a, Mapping) \
            else [_convert(path, a)]
        for name, v in pairs:
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
           (nn.Conv2d, "kernel", lambda w: w.transpose(2, 3, 1, 0)),
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
_PERM = ((nn.Linear, (1, 0)), (nn.Conv1d, (2, 1, 0)),
         (nn.Conv2d, (2, 3, 1, 0)))


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
    first name ``named_modules`` gives it. A one-layer ``nn.GRU`` /
    ``nn.LSTM`` becomes its flax cell(s) (module docstring)."""
    tree: Dict[str, Any] = {}
    for mod_name, mod in model.named_modules():
        params = {}
        for p_name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            v = p if values is None else values[full]
            params[p_name] = v.detach().to("cpu", torch.float32).numpy()
        if not params:
            continue
        parts = mod_name.split(".") if mod_name else []
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if isinstance(mod, (nn.GRU, nn.LSTM)):
            node.update(_unpack_rnn(mod, parts[-1], params))
            continue
        if parts:
            node = node.setdefault(parts[-1], {})
        for p_name, a in params.items():
            leaf, a = _flax_leaf(mod, p_name, a)
            node[leaf] = np.ascontiguousarray(a)
    return tree


def _unpack_rnn(mod: nn.RNNBase, name: str, params: Dict[str, np.ndarray]
                ) -> Dict[str, Any]:
    """{flax cell name: cell tree} of a one-layer GRU / LSTM's tensors."""
    if mod.num_layers != 1:
        raise ValueError(f"{name}: only one-layer recurrent modules map to "
                         "a flax cell")
    gru = isinstance(mod, nn.GRU)
    ins, hids = ((_GRU_INPUT, _GRU_HIDDEN) if gru
                 else (_LSTM_INPUT, _LSTM_HIDDEN))
    dirs = ((f"{name}_fwd", "_l0"), (f"{name}_bwd", "_l0_reverse")) \
        if mod.bidirectional else ((name, "_l0"),)
    out = {}
    for cell_name, sfx in dirs:
        w_ih, w_hh, b_ih, b_hh = (np.split(params[f"{what}{sfx}"], len(ins))
                                  for what in ("weight_ih", "weight_hh",
                                               "bias_ih", "bias_hh"))
        cell = {}
        for g, (i_name, h_name) in enumerate(zip(ins, hids)):
            cell[i_name] = {"kernel": np.ascontiguousarray(w_ih[g].T)}
            cell[h_name] = {"kernel": np.ascontiguousarray(w_hh[g].T)}
            # GRU: r and z take both biases on the input dense, n its input
            # bias there and b_hn on the hidden dense (inside r's product);
            # LSTM: each gate's two biases on the hidden dense
            if not gru:
                cell[h_name]["bias"] = b_hh[g] + b_ih[g]
            elif g < 2:
                cell[i_name]["bias"] = b_ih[g] + b_hh[g]
            else:
                cell[i_name]["bias"] = b_ih[g].copy()
                cell[h_name]["bias"] = b_hh[g].copy()
        out[cell_name] = cell
    return out


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
