"""Core layers of the port, channel-last [B, T, C].

Port of the main-path parts of ``diff_vits_tpu/nn/layers.py``: the
channel ``LayerNorm`` (:25-33), ``DDSConv`` (:62-88), ``WN`` (:141-190),
the relative-position ``MultiHeadAttention`` in its banded form with its
route through kernel K5 (:232-410), ``FFN`` (:413-443) and the VITS
``Encoder`` (:446-487), with dropout where the JAX modules have it. Masks
are float [B, T, 1] (1 = keep), as in the JAX package.

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
    fused_rel_self_attention, fused_rel_self_attention_plain)


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
    """Relative-position multi-head self-attention (VITS), banded form with
    a head-shared window of relative keys and values; masked scores are
    replaced by -1e4 (layers.py:285-410).

    Routing (``use_fused``, the JAX module's switch, layers.py:291-319):
    on a CUDA tensor in eval mode, when autograd records nothing for the
    call, ``True`` (the default) sends it through kernel K5
    (``ops.fused_rel_self_attention``) at every batch and length: K5 beat
    the plain route at every serving shape measured on the H100 (B 1 and
    8, T 128 and 601; PERF.md), where JAX keeps its kernel opt-in.
    ``False``, training mode, a recorded forward (K5 has no backward) and
    the CPU take the plain banded formulation, with dropout on the
    probabilities in training."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0,
                 use_fused: bool = True):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        self.p_dropout, self.use_fused = p_dropout, use_fused
        self.k_channels = channels // n_heads
        self.conv_q = nn.Linear(channels, channels)
        self.conv_k = nn.Linear(channels, channels)
        self.conv_v = nn.Linear(channels, channels)
        self.conv_o = nn.Linear(channels, out_channels)
        shape = (1, 2 * window_size + 1, self.k_channels)
        self.emb_rel_k = nn.Parameter(torch.zeros(shape))
        self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def _fused_enabled(self, x: torch.Tensor) -> bool:
        recorded = torch.is_grad_enabled() and (
            x.requires_grad or self.conv_q.weight.requires_grad)
        return (self.use_fused and not self.training
                and x.device.type == "cuda" and not recorded)

    def forward(self, x, lengths: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C]; ``lengths`` [B] the kept prefix of each item (None:
        nothing masked)."""
        args = (x, lengths, self.conv_q.weight.t(), self.conv_q.bias,
                self.conv_k.weight.t(), self.conv_k.bias,
                self.conv_v.weight.t(), self.conv_v.bias,
                self.conv_o.weight.t(), self.conv_o.bias, self.emb_rel_k,
                self.emb_rel_v)
        kw = dict(heads=self.n_heads, window=self.window_size,
                  compute_dtype=self.conv_q.weight.dtype)
        if self._fused_enabled(x):
            return fused_rel_self_attention(*args, **kw)
        p_drop = None
        if self.training and self.p_dropout > 0.0:
            def p_drop(p):
                return dropout(p, self.p_dropout, True, generator)
        return fused_rel_self_attention_plain(*args, p_drop=p_drop, **kw)


class FFN(nn.Module):
    """Conv feed-forward with SAME padding and ReLU (layers.py:413)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, *,
                generator: Optional[torch.Generator] = None):
        x = self.conv_1(F.pad(x * x_mask, (0, 0) + self.pad))
        x = dropout(torch.relu(x), self.p_dropout, self.training, generator)
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
