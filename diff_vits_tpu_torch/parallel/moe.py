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
JAX computes them outside any Pallas kernel. Sharding the expert axis over
an ``expert`` mesh axis (JAX's ``expert_sharding_rules``) is not ported:
``parallel.mesh.make_mesh`` refuses such an axis.
"""
from __future__ import annotations

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
        u = torch.einsum("btd,edh->ebth", x, self.w1.to(x.dtype)) \
            + self.b1[:, None, None, :]
        a, g = u.chunk(2, dim=-1)
        u = a * F.gelu(g)
        y = torch.einsum("ebth,ehd->ebtd", u, self.w2.to(u.dtype)) \
            + self.b2[:, None, None, :]
        onehot = F.one_hot(top_idx, e).float()                  # [B,T,k,E]
        combine = torch.einsum("btk,btke->bte", weights, onehot)
        return torch.einsum("bte,ebtd->btd", combine.to(y.dtype), y)
