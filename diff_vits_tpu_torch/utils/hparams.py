"""Attribute-dict hyperparameters and tolerant checkpoint merge / load.

Port of ``diff_vits_tpu/utils/hparams.py``: ``HParams`` (:13),
``merge_params`` (:69) and ``load_params_tolerant`` (:80). They take the
nested dicts JAX's take, with numpy or tensor leaves, and the port's flat
``state_dict`` (keys split on ".", the same tree in the port's layout);
what they return has the layout and leaf types of the first tree (of
``target`` for ``load_params_tolerant``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


class HParams:
    """Attribute-dict over nested config dicts."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def __len__(self):
        return len(self.__dict__)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value):
        return setattr(self, key, value)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return repr(self.__dict__)


def _is_flat(tree: Dict[str, Any]) -> bool:
    """A port ``state_dict``: no nested dicts, keys joined by "."."""
    return not any(isinstance(v, dict) for v in tree.values())


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + tuple(k.split("."))] = v
    return out


def _unflatten(flat: Dict[Tuple[str, ...], Any], like_flat: bool
               ) -> Dict[str, Any]:
    if like_flat:
        return {".".join(k): v for k, v in flat.items()}
    tree: Dict[str, Any] = {}
    for parts, v in flat.items():
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def merge_params(trees, weights=None) -> Dict[str, Any]:
    """Weighted average of parameter trees (equal weights by default), in
    float32; tensor leaves stay tensors on their device."""
    flats = [_flatten(t) for t in trees]
    weights = weights or [1.0 / len(trees)] * len(trees)
    out = {}
    for k, v in flats[0].items():
        if isinstance(v, torch.Tensor):
            out[k] = sum(w * torch.as_tensor(f[k]).to(v.device,
                                                      torch.float32)
                         for w, f in zip(weights, flats))
        else:
            out[k] = sum(w * np.asarray(f[k], np.float32)
                         for w, f in zip(weights, flats))
    return _unflatten(out, _is_flat(trees[0]))


def load_params_tolerant(target: Dict[str, Any],
                         saved: Dict[str, Any]) -> Dict[str, Any]:
    """``target`` with each leaf replaced by ``saved``'s where ``saved``
    has it at the same shape; the target's leaf is kept where the key is
    missing or the shape differs. A saved leaf takes the target leaf's
    kind (tensor on its device, or numpy) and keeps its own dtype."""
    s_flat = _flatten(saved)
    out = {}
    for k, v in _flatten(target).items():
        sv = s_flat.get(k)
        if sv is None or _shape(sv) != _shape(v):
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = torch.as_tensor(sv).to(v.device)
        else:
            out[k] = (sv.detach().cpu().numpy()
                      if isinstance(sv, torch.Tensor) else np.asarray(sv))
    return _unflatten(out, _is_flat(target))
