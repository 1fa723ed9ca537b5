"""Fairseq-style encoder layers (the PromptEncoder backbone), channel-last.

Port of ``ConvLayer``, ``TransformerFFNLayer`` and ``EncSALayer`` of
``diff_vits_tpu/nn/fairseq.py:85-228``; ``EncSALayer`` has the JAX
package's flash route (:197-203) behind ``use_flash``, off by default as in
JAX (``nn/unet1d.set_use_flash``). Keep masks are float [B, T, 1].
Dropout (train mode only, from the caller's generator) sits where the JAX
layers have it: the FFN's ReLU (:161), the attention output (:217) and the
FFN output (:226); registry code 8 sets the attention-probability dropout
(:211) to 0.

Under tensor parallelism (``parallel.sharding`` sets ``tp``), ``EncSALayer``
computes the rank's heads (``in_proj`` holds ``[q_i | k_i | v_i]``,
``out_proj`` their input features, summed over the group) and
``TransformerFFNLayer`` the rank's hidden units; the FFN's dropout draws
the whole width's mask and keeps the rank's columns, so that every rank
draws what one process draws.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.layers import Conv1d, dropout
from diff_vits_tpu_torch.nn.remat import remat_call
from diff_vits_tpu_torch.ops.flash_attention import flash_ok, sdpa


class ConvLayer(nn.Module):
    """LN -> conv(k) with symmetric k//2 padding (torch.conv_tbc)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.layer_norm = nn.LayerNorm(c_in, eps=1e-5)
        self.conv = Conv1d(c_in, c_out, kernel_size,
                           padding=kernel_size // 2)

    def forward(self, x, keep_mask=None):
        if keep_mask is not None:
            x = x * keep_mask
        x = self.conv(self.layer_norm(x))
        if self.kernel_size % 2 == 0:
            x = x[:, :-1]
        return x


class TransformerFFNLayer(nn.Module):
    """Conv FFN: SAME k-wide conv scaled by k^-1/2 -> ReLU -> Linear."""

    def __init__(self, hidden_size: int, filter_size: int,
                 kernel_size: int = 1, p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.p_dropout = kernel_size, p_dropout
        self.tp = None
        if kernel_size == 1:
            self.ffn_1 = nn.Linear(hidden_size, filter_size)
        else:
            self.ffn_1 = Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        k, tp = self.kernel_size, self.tp
        if tp is not None:
            x = tp.enter(x)
        if k == 1:
            x = self.ffn_1(x)
        else:
            pad_l = (k - 1) // 2
            x = self.ffn_1(F.pad(x, (0, 0, pad_l, k - 1 - pad_l))) * k ** -0.5
        if tp is None:
            x = dropout(torch.relu(x), self.p_dropout, self.training,
                        generator)
            return self.ffn_2(x)
        x = dropout(torch.relu(x), self.p_dropout, self.training, generator,
                    columns=(tp.index, tp.size))
        return tp.row(self.ffn_2, x)


class EncSALayer(nn.Module):
    """Pre-LN self-attention (no qkv bias, -inf key padding) + conv FFN;
    registry code 8: 8 heads, FFN kernel 9, no attention-probability dropout
    (fairseq.py:189), so the flash route (``use_flash``, the keep mask as
    the key mask) computes the same function. ``remat`` is its
    ``nn.remat`` policy."""

    def __init__(self, c: int, num_heads: int = 8, kernel_size: int = 9,
                 p_dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.p_dropout = num_heads, p_dropout
        self.use_flash = False
        self.remat = "none"
        self.tp = None
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.in_proj = nn.Linear(c, 3 * c, bias=False)
        self.out_proj = nn.Linear(c, c, bias=False)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(c, 4 * c, kernel_size=kernel_size,
                                       p_dropout=p_dropout)

    def uses_flash(self, t: int, c: int) -> bool:
        """Whether a call on [B, t, c] takes the flash route."""
        shape = (None, self.num_heads, t, c // self.num_heads)
        return flash_ok(shape, shape, self.use_flash)

    def forward(self, x, keep_mask, *,
                generator: Optional[torch.Generator] = None):
        return remat_call(self.remat, self._forward, x, keep_mask,
                          generator=generator)

    def _forward(self, x, keep_mask, *,
                 generator: Optional[torch.Generator] = None):
        b, t, c = x.shape
        d, tp = c // self.num_heads, self.tp
        heads = self.num_heads if tp is None else self.num_heads // tp.size
        h = self.layer_norm1(x)
        q, k, v = self.in_proj(h if tp is None else tp.enter(h)).chunk(3, -1)

        def split(a):
            return a.reshape(b, t, heads, d).transpose(1, 2)

        if self.uses_flash(t, c):
            out = sdpa(split(q), split(k), split(v), keep_mask[:, :, 0] > 0,
                       sm_scale=d ** -0.5, use_flash=True)
        else:
            scores = torch.matmul(split(q) * d ** -0.5,
                                  split(k).transpose(-1, -2))
            pad = keep_mask[:, None, None, :, 0] == 0
            scores = scores.masked_fill(pad, float("-inf"))
            out = torch.matmul(torch.softmax(scores, dim=-1), split(v))
        out = out.transpose(1, 2).reshape(b, t, heads * d)
        out = self.out_proj(out) if tp is None else tp.row(self.out_proj, out)
        out = dropout(out, self.p_dropout, self.training, generator)
        x = (x + out) * keep_mask
        h = self.ffn(self.layer_norm2(x), generator=generator)
        h = dropout(h, self.p_dropout, self.training, generator)
        return (x + h) * keep_mask
