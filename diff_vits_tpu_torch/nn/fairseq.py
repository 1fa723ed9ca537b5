"""Fairseq-style encoder layers (the PromptEncoder backbone), channel-last.

Port of ``ConvLayer``, ``TransformerFFNLayer`` and ``EncSALayer`` of
``diff_vits_tpu/nn/fairseq.py:85-228`` on their plain einsum path (the JAX
package's flash route is off by default). Keep masks are float [B, T, 1].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.layers import Conv1d


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
                 kernel_size: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        if kernel_size == 1:
            self.ffn_1 = nn.Linear(hidden_size, filter_size)
        else:
            self.ffn_1 = Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x):
        k = self.kernel_size
        if k == 1:
            x = self.ffn_1(x)
        else:
            pad_l = (k - 1) // 2
            x = self.ffn_1(F.pad(x, (0, 0, pad_l, k - 1 - pad_l))) * k ** -0.5
        return self.ffn_2(torch.relu(x))


class EncSALayer(nn.Module):
    """Pre-LN self-attention (no qkv bias, -inf key padding) + conv FFN;
    registry code 8: 8 heads, FFN kernel 9 (fairseq.py:189)."""

    def __init__(self, c: int, num_heads: int = 8, kernel_size: int = 9):
        super().__init__()
        self.num_heads = num_heads
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.in_proj = nn.Linear(c, 3 * c, bias=False)
        self.out_proj = nn.Linear(c, c, bias=False)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(c, 4 * c, kernel_size=kernel_size)

    def forward(self, x, keep_mask):
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = self.in_proj(self.layer_norm1(x)).chunk(3, dim=-1)

        def split(a):
            return a.reshape(b, t, self.num_heads, d).transpose(1, 2)

        scores = torch.matmul(split(q) * d ** -0.5, split(k).transpose(-1, -2))
        pad = keep_mask[:, None, None, :, 0] == 0
        scores = scores.masked_fill(pad, float("-inf"))
        out = torch.matmul(torch.softmax(scores, dim=-1), split(v))
        out = self.out_proj(out.transpose(1, 2).reshape(b, t, c))
        x = (x + out) * keep_mask
        h = self.ffn(self.layer_norm2(x))
        return (x + h) * keep_mask
