"""Fairseq-style encoder layers (the PromptEncoder backbone), channel-last.

Port of ``diff_vits_tpu/nn/fairseq.py``: the padding-aware sinusoidal
positions (:23-52), the decode KV cache (:55-82; plain tensors written in
place where JAX threads a functional cache), ``ConvLayer``,
``EncConvLayer``, ``TransformerFFNLayer``, ``EncSALayer``, the chunked
``EncLocalSALayer``, the Gaussian-biased ``EncGausSALayer``, the Bi-LSTM
``EncLSTMLayer``, ``ConvAttentionLayer`` and the ``OPERATIONS_ENCODER``
registry (:417). ``EncSALayer`` has the JAX package's flash route
(:197-203) behind ``use_flash``, off by default as in JAX
(``nn/unet1d.set_use_flash``). Keep masks are float [B, T, 1]. Dropout
(train mode only, from the caller's generator) sits where the JAX layers
have it: the FFN's ReLU (:161), the attention probabilities (:211, 0 in
registry code 8), the attention output (:217) and the FFN output (:226).

Under tensor parallelism (``parallel.sharding`` sets ``tp``), ``EncSALayer``
computes the rank's heads (``in_proj`` holds ``[q_i | k_i | v_i]``,
``out_proj`` their input features, summed over the group) and
``TransformerFFNLayer`` the rank's hidden units; the FFN's dropout draws
the whole width's mask and keeps the rank's columns, so that every rank
draws what one process draws.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.layers import Conv1d, dropout
from diff_vits_tpu_torch.nn.remat import remat_call
from diff_vits_tpu_torch.ops.flash_attention import flash_ok, sdpa


def sinusoidal_positional_embedding(positions: torch.Tensor,
                                    embedding_dim: int,
                                    padding_idx: int = 0) -> torch.Tensor:
    """tensor2tensor sinusoidal table at integer ``positions`` [B, T] ->
    [B, T, dim] ([sin, cos] halves, a zero last channel for an odd dim);
    positions equal to ``padding_idx`` embed to zero."""
    half_dim = embedding_dim // 2
    freq = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                  device=positions.device)
                     * -(math.log(10000.0) / (half_dim - 1)))
    args = positions.float()[..., None] * freq
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.masked_fill((positions == padding_idx)[..., None], 0.0)


class SinusoidalPositionalEmbedding(nn.Module):
    """Positions of a token batch [B, T]: pads (``padding_idx``) embed to
    zero, the n-th non-pad token of a row takes position padding_idx + n
    (fairseq's ``make_positions``)."""

    def __init__(self, embedding_dim: int, padding_idx: int = 0):
        super().__init__()
        self.embedding_dim, self.padding_idx = embedding_dim, padding_idx

    def forward(self, tokens):
        nonpad = (tokens != self.padding_idx).long()
        positions = torch.cumsum(nonpad, dim=1) * nonpad + self.padding_idx
        return sinusoidal_positional_embedding(
            positions, self.embedding_dim, self.padding_idx)


def init_kv_cache(batch: int, max_len: int, num_heads: int, head_dim: int,
                  dtype=torch.float32, device=None) -> Dict[str, object]:
    """An empty decode cache: k and v [B, H, max_len, D] zeros and the
    next position ``index`` 0 (fairseq's incremental ``saved_state``)."""
    shape = (batch, num_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def incremental_attention_step(q_t, k_t, v_t, cache):
    """One autoregressive step: q_t / k_t / v_t [B, H, 1, D] of the new
    token; k_t and v_t are written into the cache at ``index`` (in place)
    and the query attends over positions 0 .. index. Returns
    (out [B, H, 1, D], the cache with ``index`` advanced)."""
    idx = cache["index"]
    k, v = cache["k"], cache["v"]
    k[:, :, idx:idx + 1] = k_t
    v[:, :, idx:idx + 1] = v_t
    scores = torch.matmul(q_t * q_t.shape[-1] ** -0.5, k.transpose(-1, -2))
    pos = torch.arange(k.shape[2], device=k.device)
    scores = scores.masked_fill(pos > idx, float("-inf"))
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    cache["index"] = idx + 1
    return out, cache


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


class EncConvLayer(nn.Module):
    """Residual block: mask -> LN -> k conv (k//2 a side, the last frame
    dropped for even k) -> ReLU -> dropout, + the unmasked input."""

    def __init__(self, c: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.p_dropout = kernel_size, p_dropout
        self.layer_norm = nn.LayerNorm(c, eps=1e-5)
        self.conv = Conv1d(c, c, kernel_size, padding=kernel_size // 2)

    def forward(self, x, keep_mask=None, *,
                generator: Optional[torch.Generator] = None):
        residual = x
        if keep_mask is not None:
            x = x * keep_mask
        h = self.conv(self.layer_norm(x))
        if self.kernel_size % 2 == 0:
            h = h[:, :-1]
        h = dropout(torch.relu(h), self.p_dropout, self.training, generator)
        return h + residual


class TransformerFFNLayer(nn.Module):
    """Conv FFN: a k-wide conv (SAME, or ``padding="LEFT"``: causal)
    scaled by k^-1/2 -> ReLU -> Linear."""

    def __init__(self, hidden_size: int, filter_size: int,
                 kernel_size: int = 1, p_dropout: float = 0.0,
                 padding: str = "SAME"):
        super().__init__()
        self.kernel_size, self.p_dropout = kernel_size, p_dropout
        self.padding = padding
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
            pad_l = (k - 1) // 2 if self.padding == "SAME" else k - 1
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
    the key mask) computes the same function; with ``attention_dropout``
    > 0 the layer takes the plain route, as JAX's gate does (:197).
    ``relu_dropout`` (None: ``p_dropout``) is the FFN's. ``remat`` is its
    ``nn.remat`` policy."""

    def __init__(self, c: int, num_heads: int = 8, kernel_size: int = 9,
                 p_dropout: float = 0.0, attention_dropout: float = 0.0,
                 relu_dropout: Optional[float] = None,
                 ffn_padding: str = "SAME"):
        super().__init__()
        self.num_heads, self.p_dropout = num_heads, p_dropout
        self.attention_dropout = attention_dropout
        self.use_flash = False
        self.remat = "none"
        self.tp = None
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.in_proj = nn.Linear(c, 3 * c, bias=False)
        self.out_proj = nn.Linear(c, c, bias=False)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(
            c, 4 * c, kernel_size=kernel_size,
            p_dropout=p_dropout if relu_dropout is None else relu_dropout,
            padding=ffn_padding)

    def uses_flash(self, t: int, c: int) -> bool:
        """Whether a call on [B, t, c] takes the flash route."""
        shape = (None, self.num_heads, t, c // self.num_heads)
        return self.attention_dropout == 0.0 and flash_ok(shape, shape,
                                                          self.use_flash)

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
            p = dropout(torch.softmax(scores, dim=-1), self.attention_dropout,
                        self.training, generator)
            out = torch.matmul(p, split(v))
        out = out.transpose(1, 2).reshape(b, t, heads * d)
        out = self.out_proj(out) if tp is None else tp.row(self.out_proj, out)
        out = dropout(out, self.p_dropout, self.training, generator)
        x = (x + out) * keep_mask
        h = self.ffn(self.layer_norm2(x), generator=generator)
        h = dropout(h, self.p_dropout, self.training, generator)
        return (x + h) * keep_mask


class EncLocalSALayer(nn.Module):
    """Pre-LN self-attention over a band of ``chunk_size`` keys (|i - j| <=
    chunk_size // 2; out-of-band and padded keys at -1e9) + conv FFN
    (kernel 9); registry code 11."""

    def __init__(self, c: int, num_heads: int, p_dropout: float = 0.0,
                 attention_dropout: float = 0.1, relu_dropout: float = 0.1,
                 chunk_size: int = 101):
        super().__init__()
        self.num_heads, self.p_dropout = num_heads, p_dropout
        self.attention_dropout, self.chunk_size = attention_dropout, chunk_size
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.in_proj = nn.Linear(c, 3 * c, bias=False)
        self.out_proj = nn.Linear(c, c, bias=False)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(c, 4 * c, kernel_size=9,
                                       p_dropout=relu_dropout)

    def forward(self, x, keep_mask, *,
                generator: Optional[torch.Generator] = None):
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = self.in_proj(self.layer_norm1(x)).chunk(3, -1)

        def split(a):
            return a.reshape(b, t, self.num_heads, d).transpose(1, 2)

        scores = torch.matmul(split(q) * d ** -0.5,
                              split(k).transpose(-1, -2))
        pos = torch.arange(t, device=x.device)
        band = (pos[:, None] - pos[None, :]).abs() <= self.chunk_size // 2
        scores = scores.masked_fill(~band, -1e9)
        scores = scores.masked_fill(keep_mask[:, None, None, :, 0] == 0, -1e9)
        p = dropout(torch.softmax(scores, dim=-1), self.attention_dropout,
                    self.training, generator)
        out = torch.matmul(p, split(v)).transpose(1, 2).reshape(b, t, c)
        out = dropout(self.out_proj(out), self.p_dropout, self.training,
                      generator)
        x = (x + out) * keep_mask
        h = self.ffn(self.layer_norm2(x), generator=generator)
        h = dropout(h, self.p_dropout, self.training, generator)
        return (x + h) * keep_mask


class EncGausSALayer(nn.Module):
    """Pre-LN self-attention with biased q/k/v and a learnable Gaussian
    locality prior -(i - j)^2 / 2 * tao^-4 a head (``gaus_bias``) + conv
    FFN (kernel 9); registry code 13 is single-head. As in the reference,
    the residual stream is not re-masked."""

    def __init__(self, c: int, num_heads: int = 1, p_dropout: float = 0.0,
                 attention_dropout: float = 0.1, relu_dropout: float = 0.1,
                 gaus_bias: bool = False, gaus_tao: float = 10.0):
        super().__init__()
        self.num_heads, self.p_dropout = num_heads, p_dropout
        self.attention_dropout = attention_dropout
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.w_q = nn.Linear(c, c)
        self.w_k = nn.Linear(c, c)
        self.w_v = nn.Linear(c, c)
        self.fc = nn.Linear(c, c)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(c, 4 * c, kernel_size=9,
                                       p_dropout=relu_dropout)
        self.tao = (nn.Parameter(torch.full((num_heads,), float(gaus_tao)))
                    if gaus_bias else None)

    def forward(self, x, keep_mask, *,
                generator: Optional[torch.Generator] = None):
        b, t, c = x.shape
        d = c // self.num_heads
        h = self.layer_norm1(x)

        def split(a):
            return a.reshape(b, t, self.num_heads, d).transpose(1, 2)

        scores = torch.matmul(split(self.w_q(h)) * d ** -0.5,
                              split(self.w_k(h)).transpose(-1, -2))
        if self.tao is not None:
            i = torch.arange(t, dtype=torch.float32, device=x.device)
            gauss = -((i[None, :] - i[:, None]) ** 2) / 2.0
            scores = scores + (gauss[None, None] * (
                self.tao ** -4.0)[None, :, None, None]).to(scores.dtype)
        scores = scores.masked_fill(keep_mask[:, None, None, :, 0] == 0,
                                    float("-inf"))
        p = dropout(torch.softmax(scores, dim=-1), self.attention_dropout,
                    self.training, generator)
        out = torch.matmul(p, split(self.w_v(h))).transpose(1, 2) \
            .reshape(b, t, c)
        x = x + dropout(self.fc(out), self.p_dropout, self.training,
                        generator)
        h = self.ffn(self.layer_norm2(x), generator=generator)
        return x + dropout(h, self.p_dropout, self.training, generator)


class EncLSTMLayer(nn.Module):
    """LN -> Bi-LSTM (hidden c each way) -> Linear(2c, c) -> dropout, +
    residual, masked; registry code 12. Both directions run over the whole
    padded sequence, unpacked, as JAX's ``nn.RNN`` without lengths does
    (the backward one from the last padded frame); ``lstm`` carries flax's
    ``lstm_fwd`` / ``lstm_bwd`` cells (``utils.convert``)."""

    def __init__(self, c: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.layer_norm = nn.LayerNorm(c, eps=1e-5)
        self.lstm = nn.LSTM(c, c, batch_first=True, bidirectional=True)
        self.out_proj = nn.Linear(2 * c, c)

    def forward(self, x, keep_mask=None, *,
                generator: Optional[torch.Generator] = None):
        h, _ = self.lstm(self.layer_norm(x))
        h = dropout(self.out_proj(h), self.p_dropout, self.training,
                    generator)
        out = x + h
        return out * keep_mask if keep_mask is not None else out


class ConvAttentionLayer(nn.Module):
    """Single-head enc-dec attention of the convolutional seq2seq models:
    q = in_projection(x) [B, T, hidden] against ``key`` [B, S, hidden],
    fully masked rows 0, the output scaled by sqrt(number of kept keys)
    and projected back to c. Returns (out, probabilities, logits)."""

    def __init__(self, c: int, hidden_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.in_projection = nn.Linear(c, hidden_size)
        self.out_projection = nn.Linear(hidden_size, c)

    def forward(self, x, key, value, key_keep_mask=None,
                attn_constraint_mask=None, *,
                generator: Optional[torch.Generator] = None):
        """``key_keep_mask`` [B, S] boolean (True = keep);
        ``attn_constraint_mask`` broadcastable to [B, T, S] (True =
        forbid)."""
        scores = torch.matmul(self.in_projection(x), key.transpose(-1, -2))
        if key_keep_mask is not None:
            scores = scores.masked_fill(~key_keep_mask[:, None, :],
                                        float("-inf"))
        if attn_constraint_mask is not None:
            scores = scores.masked_fill(attn_constraint_mask, float("-inf"))
        logits = scores
        p = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
        p = dropout(p, self.p_dropout, self.training, generator)
        out = torch.matmul(p, value)
        s = value.shape[1]
        if key_keep_mask is None:
            out = out * (s * math.sqrt(1.0 / s))
        else:
            n = key_keep_mask.to(out.dtype).sum(dim=1)[:, None, None]
            out = out * torch.sqrt(n.clamp(min=1.0))
        return self.out_projection(out), p, logits


# registry codes (fairseq.py:417; c = hidden size)
OPERATIONS_ENCODER = {
    1: lambda c, dropout: EncConvLayer(c, 1, dropout),
    2: lambda c, dropout: EncConvLayer(c, 5, dropout),
    3: lambda c, dropout: EncConvLayer(c, 9, dropout),
    4: lambda c, dropout: EncConvLayer(c, 13, dropout),
    5: lambda c, dropout: EncConvLayer(c, 17, dropout),
    6: lambda c, dropout: EncConvLayer(c, 21, dropout),
    7: lambda c, dropout: EncConvLayer(c, 25, dropout),
    8: lambda c, dropout: EncSALayer(
        c, 8, kernel_size=9, p_dropout=dropout, attention_dropout=0.0,
        relu_dropout=dropout, ffn_padding="SAME"),
    9: lambda c, dropout: EncSALayer(c, 4, p_dropout=dropout,
                                     relu_dropout=0.1),
    10: lambda c, dropout: EncSALayer(c, 8, p_dropout=dropout,
                                      relu_dropout=0.1),
    11: lambda c, dropout: EncLocalSALayer(c, 2, dropout),
    12: lambda c, dropout: EncLSTMLayer(c, dropout),
    13: lambda c, dropout, g_bias=True, tao=10.0: EncGausSALayer(
        c, 1, dropout, gaus_bias=g_bias, gaus_tao=tao),
    14: lambda c, dropout: EncSALayer(c, 2, kernel_size=1, p_dropout=dropout,
                                      relu_dropout=0.1),
    15: lambda c, dropout: EncSALayer(c, 2, kernel_size=15,
                                      p_dropout=dropout, relu_dropout=0.1),
}
