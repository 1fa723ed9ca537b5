"""Mixture-of-experts feed-forward.

Port of ``MoEFeedForward`` of ``diff_vits_tpu/parallel/moe.py:26-67``: a
gate ``Linear`` without bias, top-k over float32 logits, a softmax of the
top values, dense dispatch (every expert computes every token, one stacked
product over the expert axis) with an exact-erf GEGLU, and the
gate-weighted combine of the selected experts through a one-hot product.
No token is dropped, there is no capacity factor and no balancing loss.

The stacked expert weights ``w1`` [E, D, 2H], ``b1`` [E, 2H], ``w2``
[E, H, D] and ``b2`` [E, D] are raw parameters under the flax names and
in JAX's layout (``utils.convert`` carries them unchanged); the gate is an
``nn.Linear`` named ``gate``. The expert products are plain einsums, as
JAX computes them outside any Pallas kernel.

Expert parallelism (``moe.py:69-84`` and the ``ff_moe`` branch of
``mesh.state_sharding_rules``): when ``parallel.sharding`` gives the
module an ``ep`` group, ``w1`` .. ``b2`` hold the rank's block of experts
(the rank at coordinate i of n holds experts i E/n .. (i+1) E/n - 1), every
rank of the group has the same rows, and the module computes its local
experts for them; the gate-weighted combine of the local experts is
completed by a sum over the group. The gate runs whole on every rank.
:func:`expert_sharding_rules` is JAX's rule for a params tree of its own.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class MoEFeedForward(nn.Module):
    """Top-k gated expert GEGLU feed-forward over [B, T, D] tokens."""

    def __init__(self, dim: int, num_experts: int, top_k: int = 2,
                 mult: int = 4):
        super().__init__()
        e, d, h = num_experts, dim, dim * mult
        self.num_experts, self.top_k = num_experts, top_k
        self.ep = None          # parallel.sharding.Group when experts split
        self.gate = nn.Linear(d, e, bias=False)
        self.w1 = nn.Parameter(torch.zeros(e, d, 2 * h))
        self.b1 = nn.Parameter(torch.zeros(e, 2 * h))
        self.w2 = nn.Parameter(torch.zeros(e, h, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.num_experts
        logits = self.gate(x)                                   # [B, T, E]
        top_vals, top_idx = torch.topk(logits.float(), min(self.top_k, e),
                                       dim=-1)
        weights = torch.softmax(top_vals, dim=-1)               # [B, T, k]
        onehot = F.one_hot(top_idx, e).float()                  # [B,T,k,E]
        combine = torch.einsum("btk,btke->bte", weights, onehot)
        ep = self.ep
        if ep is not None:      # the local experts, on the group's rows
            n = self.w1.shape[0]
            x = ep.enter(x)
            combine = ep.enter(combine)[..., ep.index * n:(ep.index + 1) * n]
        u = torch.einsum("btd,edh->ebth", x, self.w1.to(x.dtype)) \
            + self.b1[:, None, None, :]
        a, g = u.chunk(2, dim=-1)
        u = a * F.gelu(g)
        y = torch.einsum("ebth,ehd->ebtd", u, self.w2.to(u.dtype)) \
            + self.b2[:, None, None, :]
        out = torch.einsum("bte,ebtd->btd", combine.to(y.dtype), y)
        return out if ep is None else ep.reduce(out)


def expert_sharding_rules(mesh: Mapping[str, int],
                          leaves: Mapping[str, Sequence[int]],
                          axis_name: str = "expert"
                          ) -> Dict[str, Tuple[Optional[str], ...]]:
    """JAX's ``expert_sharding_rules`` over ``leaves`` (flax path -> flax
    shape): a leaf of 2 or more dims whose path holds ``w1``, ``w2``,
    ``b1`` or ``b2`` and whose leading dim ``axis_name`` divides splits
    that dim over ``axis_name``; every other leaf is replicated."""
    size = mesh.get(axis_name, 1)
    out = {}
    for path, shape in leaves.items():
        spec = [None] * len(shape)
        if size > 1 and len(shape) >= 2 and \
                any(h in path for h in ("w1", "w2", "b1", "b2")) and \
                shape[0] % size == 0:
            spec[0] = axis_name
        out[path] = tuple(spec)
    return out
