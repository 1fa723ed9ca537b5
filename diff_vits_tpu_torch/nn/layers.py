"""Core layers of the port, channel-last [B, T, C].

Port of ``diff_vits_tpu/nn/layers.py``: the channel ``LayerNorm``
(:25-33), ``ConvReluNorm`` (:36), ``DDSConv`` (:62-88), the HiFi-GAN
``ResBlock1`` / ``ResBlock2`` (:91, :121), ``WN`` (:141-190), the
relative-position ``MultiHeadAttention`` with its route through kernel K5
and its general form (:232-410), ``FFN`` (:413-443), the VITS ``Encoder``
(:446-487) and the causal ``Decoder`` (:490), with dropout where the JAX
modules have it. Masks are float [B, T, 1] (1 = keep), as in the JAX
package. Convs with SAME padding pad as flax does: (k - 1) * dilation in
all, the odd one on the right.

Dropout is active only in ``train()`` mode, and every mask is drawn from
the ``torch.Generator`` the caller passes down (never the global stream);
flax's ``nn.Dropout`` semantics: keep with probability 1 - p, scale kept
values by 1 / (1 - p).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.nn.remat import remat_call
from diff_vits_tpu_torch.ops.rel_attention import (
    abs_to_band, band_embeddings, band_to_abs, fused_rel_self_attention,
    fused_rel_self_attention_plain)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator],
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator``; identity in eval mode or
    at p = 0. Training with p > 0 needs a generator on x's device.
    ``columns`` (i, n): ``x`` is block i of n equal blocks of the last dim
    of a wider tensor; the wider tensor's mask is drawn and block i kept."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    if columns is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        i, n = columns
        c = x.shape[-1]
        keep = torch.rand(x.shape[:-1] + (c * n,), generator=generator,
                          device=x.device)[..., i * c:(i + 1) * c] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on channel-last input: [B, T, Ci] -> [B, T', Co],
    returned contiguous (the fused ops take contiguous activations).
    Parameters keep PyTorch's layout (weight [Co, Ci, k])."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.transpose(1, 2))
        return y.transpose(1, 2).contiguous()


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis, eps 1e-5, held as a submodule
    ``ln`` as in the JAX module (layers.py:25-33)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.ln = nn.LayerNorm(channels, eps=eps)

    def forward(self, x):
        return self.ln(x)


class ConvReluNorm(nn.Module):
    """(conv k SAME -> LayerNorm -> ReLU -> dropout) x n, then a residual
    Linear projection that starts at zero (layers.py:36)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(
                in_channels if i == 0 else hidden_channels, hidden_channels,
                kernel_size, padding="same"))
            self.add_module(f"norm_{i}", nn.LayerNorm(hidden_channels,
                                                      eps=1e-5))
        self.proj = nn.Linear(hidden_channels, out_channels)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, *,
                generator: Optional[torch.Generator] = None):
        x_org = x
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x * x_mask)
            x = torch.relu(getattr(self, f"norm_{i}")(x))
            x = dropout(x, self.p_dropout, self.training, generator)
        return (x_org + self.proj(x)) * x_mask


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (layers.py:62-88): per layer a
    depthwise k-wide conv of dilation k^i (groups = C), LayerNorm, exact
    GELU, a 1x1, LayerNorm, exact GELU, dropout, residual; the input masked
    before each depthwise conv and at the end."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        for i in range(n_layers):
            d = kernel_size ** i
            self.add_module(f"conv_sep_{i}", Conv1d(
                channels, channels, kernel_size, groups=channels, dilation=d,
                padding=(kernel_size - 1) * d // 2))
            self.add_module(f"norm1_{i}", nn.LayerNorm(channels, eps=1e-5))
            self.add_module(f"conv_1x1_{i}", nn.Linear(channels, channels))
            self.add_module(f"norm2_{i}", nn.LayerNorm(channels, eps=1e-5))

    def forward(self, x, x_mask, g=None, *,
                generator: Optional[torch.Generator] = None):
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = getattr(self, f"conv_sep_{i}")(x * x_mask)
            y = F.gelu(getattr(self, f"norm1_{i}")(y))
            y = F.gelu(getattr(self, f"norm2_{i}")(
                getattr(self, f"conv_1x1_{i}")(y)))
            x = x + dropout(y, self.p_dropout, self.training, generator)
        return x * x_mask


class ResBlock1(nn.Module):
    """HiFi-GAN residual block (layers.py:91): per dilation d, leaky ReLU
    0.1 -> k conv of dilation d -> leaky ReLU 0.1 -> k conv, + residual;
    the optional mask before each conv and at the end."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f"conv1_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d, padding="same"))
            self.add_module(f"conv2_{i}", Conv1d(
                channels, channels, kernel_size, padding="same"))

    def forward(self, x, x_mask=None):
        for i in range(self.n):
            xt = F.leaky_relu(x, 0.1)
            if x_mask is not None:
                xt = xt * x_mask
            xt = F.leaky_relu(getattr(self, f"conv1_{i}")(xt), 0.1)
            if x_mask is not None:
                xt = xt * x_mask
            x = getattr(self, f"conv2_{i}")(xt) + x
        return x * x_mask if x_mask is not None else x


class ResBlock2(nn.Module):
    """HiFi-GAN residual block (layers.py:121): per dilation d, leaky ReLU
    0.1 -> k conv of dilation d, + residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.n = len(dilation)
        for i, d in enumerate(dilation):
            self.add_module(f"conv_{i}", Conv1d(
                channels, channels, kernel_size, dilation=d, padding="same"))

    def forward(self, x, x_mask=None):
        for i in range(self.n):
            xt = F.leaky_relu(x, 0.1)
            if x_mask is not None:
                xt = xt * x_mask
            x = getattr(self, f"conv_{i}")(xt) + x
        return x * x_mask if x_mask is not None else x


class WN(nn.Module):
    """WaveNet core: dilated k-wide convs, gated tanh * sigmoid, res/skip
    1x1s, per-layer slices of one speaker-conditioning projection
    (layers.py:141-190). No dropout: its one user, the posterior encoder,
    keeps the JAX module's p = 0. ``remat`` is the ``nn.remat`` policy of
    each layer (the dilated conv, the gate and the res/skip 1x1)."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        self.remat = "none"
        self.cond_layer = (nn.Linear(gin_channels, 2 * h * n_layers)
                           if gin_channels else None)
        for i in range(n_layers):
            d = dilation_rate ** i
            # flax SAME: (k - 1) * d padding split evenly for odd k
            self.add_module(f"in_{i}", Conv1d(
                h, 2 * h, kernel_size, dilation=d,
                padding=(kernel_size - 1) * d // 2))
            self.add_module(f"res_skip_{i}", nn.Linear(
                h, 2 * h if i < n_layers - 1 else h))

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = (self.cond_layer(g) if g is not None
                 and self.cond_layer is not None else None)
        for i in range(self.n_layers):
            g_i = (None if g_all is None
                   else g_all[..., 2 * h * i:2 * h * (i + 1)])
            res_skip = remat_call(self.remat, self._layer, i, x, g_i)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask

    def _layer(self, i: int, x, g_i):
        h = self.hidden_channels
        acts = getattr(self, f"in_{i}")(x)
        if g_i is not None:
            acts = acts + g_i
        acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
        return getattr(self, f"res_skip_{i}")(acts)


class MultiHeadAttention(nn.Module):
    """Relative-position multi-head attention (VITS): a window of relative
    keys and values shared by the heads (``heads_share``) or one a head,
    masked scores replaced by -1e4 (layers.py:285-410).

    Production form (a window, heads_share, no proximal bias, no block
    band, self-attention masked by per-item ``lengths``; what the
    ``Encoder`` runs). Routing (``use_fused``, the JAX module's switch,
    layers.py:291-319): on a CUDA tensor in eval mode, when autograd
    records nothing for the call, ``True`` (the default) sends it through
    kernel K5 (``ops.fused_rel_self_attention``) at every batch and
    length: K5 beat the plain route at every serving shape measured on the
    H100 (B 1 and 8, T 128 and 601; PERF.md), where JAX keeps its kernel
    opt-in. ``False``, training mode, a recorded forward (K5 has no
    backward) and the CPU take the plain banded formulation, with dropout
    on the probabilities in training.

    General form, the plain route always (as JAX's gate, layers.py:311-315,
    sends it to XLA): keys and values from ``c`` (enc-dec attention), an
    ``attn_mask`` [B, 1 or H, T, S] (0 = discard), ``window_size=None`` (no
    relative terms), ``heads_share=False`` (tables [H, 2w+1, k]),
    ``proximal_bias`` (-log1p|i - j| on the scores), ``block_length`` (keys
    within that distance kept; applied with ``attn_mask`` only, as in JAX)
    and ``proximal_init`` (``conv_k`` starts as a copy of ``conv_q``)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = 4, p_dropout: float = 0.0,
                 use_fused: bool = True, heads_share: bool = True,
                 block_length: Optional[int] = None,
                 proximal_bias: bool = False, proximal_init: bool = False):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.window_size, self.heads_share = window_size, heads_share
        self.block_length, self.proximal_bias = block_length, proximal_bias
        self.p_dropout, self.use_fused = p_dropout, use_fused
        self.k_channels = channels // n_heads
        self.conv_q = nn.Linear(channels, channels)
        self.conv_k = nn.Linear(channels, channels)
        self.conv_v = nn.Linear(channels, channels)
        self.conv_o = nn.Linear(channels, out_channels)
        if proximal_init:
            with torch.no_grad():
                self.conv_k.weight.copy_(self.conv_q.weight)
                self.conv_k.bias.copy_(self.conv_q.bias)
        if window_size is not None:
            shape = (1 if heads_share else n_heads, 2 * window_size + 1,
                     self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.zeros(shape))
            self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def _production(self) -> bool:
        return (self.window_size is not None and self.heads_share
                and not self.proximal_bias and self.block_length is None)

    def _fused_enabled(self, x: torch.Tensor) -> bool:
        recorded = torch.is_grad_enabled() and (
            x.requires_grad or self.conv_q.weight.requires_grad)
        return (self.use_fused and not self.training
                and x.device.type == "cuda" and not recorded)

    def forward(self, x, lengths: Optional[torch.Tensor] = None, *,
                c: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C]; ``lengths`` [B] the kept prefix of each item (None:
        nothing masked); or the general form's ``c`` [B, S, C] and
        ``attn_mask`` [B, 1 or H, T, S] (a given ``lengths`` stands for
        the outer product of its keep masks)."""
        p_drop = None
        if self.training and self.p_dropout > 0.0:
            def p_drop(p):
                return dropout(p, self.p_dropout, True, generator)
        if c is not None or attn_mask is not None or not self._production():
            if attn_mask is None and lengths is not None:
                keep = (torch.arange(x.shape[1], device=x.device)[None]
                        < lengths.to(x.device)[:, None]).to(x.dtype)
                attn_mask = keep[:, None, :, None] * keep[:, None, None, :]
            return self._general(x, x if c is None else c, attn_mask, p_drop)
        args = (x, lengths, self.conv_q.weight.t(), self.conv_q.bias,
                self.conv_k.weight.t(), self.conv_k.bias,
                self.conv_v.weight.t(), self.conv_v.bias,
                self.conv_o.weight.t(), self.conv_o.bias, self.emb_rel_k,
                self.emb_rel_v)
        kw = dict(heads=self.n_heads, window=self.window_size,
                  compute_dtype=self.conv_q.weight.dtype)
        if self._fused_enabled(x):
            return fused_rel_self_attention(*args, **kw)
        return fused_rel_self_attention_plain(*args, p_drop=p_drop, **kw)

    def _general(self, x, c, attn_mask, p_drop):
        b, t_t, _ = x.shape
        t_s, d = c.shape[1], self.k_channels

        def split(a):
            return a.reshape(b, -1, self.n_heads, d).transpose(1, 2)

        qh = split(self.conv_q(x)) / math.sqrt(d)
        kh, vh = split(self.conv_k(c)), split(self.conv_v(c))
        scores = torch.matmul(qh, kh.transpose(-1, -2))
        rel = "g" if self.heads_share else "h"
        if self.window_size is not None:
            if t_s != t_t:
                raise ValueError("relative attention only for "
                                 "self-attention")
            key_band = band_embeddings(self.emb_rel_k, t_s, self.window_size)
            scores = scores + band_to_abs(torch.einsum(
                f"bhtd,{rel}md->bhtm", qh, key_band.to(qh.dtype)))
        if self.proximal_bias:
            r = torch.arange(t_s, dtype=torch.float32, device=x.device)
            scores = scores + (-torch.log1p(
                (r[None, :] - r[:, None]).abs()))[None, None].to(scores.dtype)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
            if self.block_length is not None:
                band = torch.ones(t_t, t_s, device=x.device).triu(
                    -self.block_length).tril(self.block_length)
                scores = scores.masked_fill(band == 0, -1e4)
        p = torch.softmax(scores, dim=-1)
        if p_drop is not None:
            p = p_drop(p)
        out = torch.matmul(p, vh)
        if self.window_size is not None:
            value_band = band_embeddings(self.emb_rel_v, t_s,
                                         self.window_size)
            out = out + torch.einsum(
                f"bhtm,{rel}md->bhtd", abs_to_band(p, min(self.window_size,
                                                          t_s - 1)),
                value_band.to(p.dtype))
        out = out.transpose(1, 2).reshape(b, t_t, self.channels)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward (layers.py:413): SAME padding, or ``causal`` (k - 1
    frames on the left); ReLU, or ``activation="gelu"``, which is
    x * sigmoid(1.702 x) (layers.py:436-437), not the exact GELU."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, activation: Optional[str] = None,
                 causal: bool = False):
        super().__init__()
        self.p_dropout, self.activation = p_dropout, activation
        self.pad = ((kernel_size - 1, 0) if causal
                    else ((kernel_size - 1) // 2, kernel_size // 2))
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, *,
                generator: Optional[torch.Generator] = None):
        x = self.conv_1(F.pad(x * x_mask, (0, 0) + self.pad))
        x = x * torch.sigmoid(1.702 * x) if self.activation == "gelu" \
            else torch.relu(x)
        x = dropout(x, self.p_dropout, self.training, generator)
        x = self.conv_2(F.pad(x * x_mask, (0, 0) + self.pad))
        return x * x_mask


class Encoder(nn.Module):
    """Post-LN relative-position transformer encoder; the speaker embedding
    is added before layer ``cond_layer_idx`` (layers.py:446-487). ``remat``
    is the ``nn.remat`` policy of each layer (attention and FFN)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4,
                 gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.n_layers, self.cond_layer_idx = n_layers, cond_layer_idx
        self.p_dropout = p_dropout
        self.remat = "none"
        h = hidden_channels
        if gin_channels and n_layers > cond_layer_idx:
            self.spk_emb_linear = nn.Linear(gin_channels, h)
        else:
            self.spk_emb_linear = None
        for i in range(n_layers):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                h, h, n_heads, window_size=window_size, p_dropout=p_dropout))
            self.add_module(f"norm1_{i}", nn.LayerNorm(h, eps=1e-5))
            self.add_module(f"ffn_{i}", FFN(h, h, filter_channels,
                                            kernel_size, p_dropout))
            self.add_module(f"norm2_{i}", nn.LayerNorm(h, eps=1e-5))

    def forward(self, x, x_mask, g: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        # the attention mask is the outer product of this length mask
        lengths = (x_mask[..., 0] > 0).sum(dim=1)
        x = x * x_mask
        for i in range(self.n_layers):
            if (i == self.cond_layer_idx and g is not None
                    and self.spk_emb_linear is not None):
                x = (x + self.spk_emb_linear(g)) * x_mask
            x = remat_call(self.remat, self._layer, i, x, x_mask, lengths,
                           generator=generator)
        return x * x_mask

    def _layer(self, i: int, x, x_mask, lengths, *,
               generator: Optional[torch.Generator] = None):
        y = getattr(self, f"attn_{i}")(x, lengths, generator=generator)
        y = dropout(y, self.p_dropout, self.training, generator)
        x = getattr(self, f"norm1_{i}")(x + y)
        y = getattr(self, f"ffn_{i}")(x, x_mask, generator=generator)
        y = dropout(y, self.p_dropout, self.training, generator)
        return getattr(self, f"norm2_{i}")(x + y)


class Decoder(nn.Module):
    """Causal post-LN transformer decoder with enc-dec attention
    (layers.py:490): per layer, causal self-attention (no relative window;
    ``proximal_bias`` / ``proximal_init`` as given), attention over the
    encoder states ``h`` masked by both masks, and a causal FFN."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, proximal_bias: bool = False,
                 proximal_init: bool = True):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        h = hidden_channels
        for i in range(n_layers):
            self.add_module(f"self_attn_{i}", MultiHeadAttention(
                h, h, n_heads, window_size=None, p_dropout=p_dropout,
                proximal_bias=proximal_bias, proximal_init=proximal_init))
            self.add_module(f"norm0_{i}", nn.LayerNorm(h, eps=1e-5))
            self.add_module(f"encdec_attn_{i}", MultiHeadAttention(
                h, h, n_heads, window_size=None, p_dropout=p_dropout))
            self.add_module(f"norm1_{i}", nn.LayerNorm(h, eps=1e-5))
            self.add_module(f"ffn_{i}", FFN(h, h, filter_channels,
                                            kernel_size, p_dropout,
                                            causal=True))
            self.add_module(f"norm2_{i}", nn.LayerNorm(h, eps=1e-5))

    def forward(self, x, x_mask, h, h_mask, *,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C], x_mask [B, T, 1]; h [B, S, C], h_mask [B, S, 1]."""
        t = x.shape[1]
        self_mask = torch.ones(t, t, device=x.device).tril()[None, None]
        encdec_mask = x_mask[:, None, :, :] * h_mask[:, None, None, :, 0]
        x = x * x_mask

        def residual(y):
            return dropout(y, self.p_dropout, self.training, generator)
        for i in range(self.n_layers):
            y = getattr(self, f"self_attn_{i}")(
                x, attn_mask=self_mask, generator=generator)
            x = getattr(self, f"norm0_{i}")(x + residual(y))
            y = getattr(self, f"encdec_attn_{i}")(
                x, c=h, attn_mask=encdec_mask, generator=generator)
            x = getattr(self, f"norm1_{i}")(x + residual(y))
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator=generator)
            x = getattr(self, f"norm2_{i}")(x + residual(y))
        return x * x_mask
