"""Layers of the reference, channel-last [B, T, C]: dropout, convs, the
WaveNet stack, the relative-position transformer encoder, the prompt
encoder's self-attention layer, the flows and the spline, the timestep and
text embeddings, masking helpers and the plain MAS.

Copied from the port's plain route. Masks are float [B, T, 1] (1 = keep).
Dropout is active only in ``train()`` mode and draws its masks through
``draws`` from the generator passed down.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import draws


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask [B, T]: True for positions < length."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-token frame counts [B, Tx] -> hard alignment [B, Ty, Tx]."""
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)
    frame = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    below = frame[None, :, None] < cum[:, None, :]
    below_prev = F.pad(below[:, :, :-1], (1, 0))
    return (below & ~below_prev).to(mask.dtype) * mask


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - p, scale by 1/(1-p)."""
    if not training or p == 0.0:
        return x
    keep = draws.rand(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on channel-last input, weight [Co, Ci, k]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2).contiguous()


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack."""

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

    def forward(self, x, x_mask, g=None, *, generator=None):
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
    """WaveNet core: dilated convs, gated tanh * sigmoid, res/skip 1x1s."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        self.cond_layer = (nn.Linear(gin_channels, 2 * h * n_layers)
                           if gin_channels else None)
        for i in range(n_layers):
            d = dilation_rate ** i
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
            acts = getattr(self, f"in_{i}")(x)
            if g_all is not None:
                acts = acts + g_all[..., 2 * h * i:2 * h * (i + 1)]
            acts = torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask


def _band(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """The centre [g, 2w'+1, d] of a relative table, w' = min(w, L - 1)."""
    w_eff = min(window, length - 1)
    start = window - w_eff
    return emb[:, start:start + 2 * w_eff + 1]


def _band_to_abs(band: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2w+1] band logits -> [B, H, L, L] (zero off the band)."""
    l, width = band.shape[-2], band.shape[-1]
    w = (width - 1) // 2
    out = band.new_zeros(band.shape[:-1] + (l,))
    for j in range(width):
        off = j - w
        t = torch.arange(max(0, -off), min(l, l - off), device=band.device)
        out[..., t, t + off] = band[..., t, j]
    return out


def _abs_to_band(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, L, L] -> [B, H, L, 2w+1], band[..., t, j] = x[..., t, t+j-w]."""
    l = x.shape[-1]
    out = x.new_zeros(x.shape[:-1] + (2 * w + 1,))
    for j in range(2 * w + 1):
        off = j - w
        t = torch.arange(max(0, -off), min(l, l - off), device=x.device)
        out[..., t, j] = x[..., t, t + off]
    return out


class MultiHeadAttention(nn.Module):
    """Relative-position self-attention over per-item lengths: a window of
    relative keys and values shared by the heads, masked scores -1e4."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.window_size, self.p_dropout = window_size, p_dropout
        self.k_channels = channels // n_heads
        self.conv_q = nn.Linear(channels, channels)
        self.conv_k = nn.Linear(channels, channels)
        self.conv_v = nn.Linear(channels, channels)
        self.conv_o = nn.Linear(channels, out_channels)
        shape = (1, 2 * window_size + 1, self.k_channels)
        self.emb_rel_k = nn.Parameter(torch.zeros(shape))
        self.emb_rel_v = nn.Parameter(torch.zeros(shape))

    def forward(self, x, lengths, *, generator=None):
        b, t, c = x.shape
        d = self.k_channels

        def heads_of(a):
            return a.reshape(b, t, self.n_heads, d).transpose(1, 2)

        qh = heads_of(self.conv_q(x) * d ** -0.5)
        kh, vh = heads_of(self.conv_k(x)), heads_of(self.conv_v(x))
        scores = torch.matmul(qh, kh.transpose(-1, -2))
        key_band = _band(self.emb_rel_k, t, self.window_size).to(qh.dtype)
        scores = scores + _band_to_abs(
            torch.einsum("bhtd,gmd->bhtm", qh, key_band))
        keep = (torch.arange(t, device=x.device)[None]
                < lengths.to(x.device)[:, None])
        mask = keep[:, None, :, None] & keep[:, None, None, :]
        scores = scores.masked_fill(~mask, -1e4)
        p = torch.softmax(scores, dim=-1)
        p = dropout(p, self.p_dropout, self.training, generator)
        out = torch.matmul(p, vh)
        value_band = _band(self.emb_rel_v, t, self.window_size).to(p.dtype)
        out = out + torch.einsum(
            "bhtm,gmd->bhtd", _abs_to_band(p, min(self.window_size, t - 1)),
            value_band)
        return self.conv_o(out.transpose(1, 2).reshape(b, t, c))


class FFN(nn.Module):
    """Conv feed-forward, SAME padding, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, *, generator=None):
        x = torch.relu(self.conv_1(F.pad(x * x_mask, (0, 0) + self.pad)))
        x = dropout(x, self.p_dropout, self.training, generator)
        return self.conv_2(F.pad(x * x_mask, (0, 0) + self.pad)) * x_mask


class Encoder(nn.Module):
    """Post-LN relative-position encoder; the speaker embedding is added
    before layer ``cond_layer_idx``."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4,
                 gin_channels: int = 0, cond_layer_idx: int = 2):
        super().__init__()
        self.n_layers, self.cond_layer_idx = n_layers, cond_layer_idx
        self.p_dropout = p_dropout
        h = hidden_channels
        self.spk_emb_linear = (nn.Linear(gin_channels, h)
                               if gin_channels and n_layers > cond_layer_idx
                               else None)
        for i in range(n_layers):
            self.add_module(f"attn_{i}", MultiHeadAttention(
                h, h, n_heads, window_size=window_size, p_dropout=p_dropout))
            self.add_module(f"norm1_{i}", nn.LayerNorm(h, eps=1e-5))
            self.add_module(f"ffn_{i}", FFN(h, h, filter_channels,
                                            kernel_size, p_dropout))
            self.add_module(f"norm2_{i}", nn.LayerNorm(h, eps=1e-5))

    def forward(self, x, x_mask, g=None, *, generator=None):
        lengths = (x_mask[..., 0] > 0).sum(dim=1)
        x = x * x_mask
        for i in range(self.n_layers):
            if (i == self.cond_layer_idx and g is not None
                    and self.spk_emb_linear is not None):
                x = (x + self.spk_emb_linear(g)) * x_mask
            y = getattr(self, f"attn_{i}")(x, lengths, generator=generator)
            y = dropout(y, self.p_dropout, self.training, generator)
            x = getattr(self, f"norm1_{i}")(x + y)
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator=generator)
            y = dropout(y, self.p_dropout, self.training, generator)
            x = getattr(self, f"norm2_{i}")(x + y)
        return x * x_mask


class ConvLayer(nn.Module):
    """LN -> conv(k) with symmetric k//2 padding."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.layer_norm = nn.LayerNorm(c_in, eps=1e-5)
        self.conv = Conv1d(c_in, c_out, kernel_size, padding=kernel_size // 2)

    def forward(self, x, keep_mask=None):
        if keep_mask is not None:
            x = x * keep_mask
        x = self.conv(self.layer_norm(x))
        return x[:, :-1] if self.kernel_size % 2 == 0 else x


class TransformerFFNLayer(nn.Module):
    """k-wide SAME conv scaled by k^-1/2 -> ReLU -> dropout -> Linear."""

    def __init__(self, hidden_size: int, filter_size: int,
                 kernel_size: int = 1, p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.p_dropout = kernel_size, p_dropout
        self.ffn_1 = Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x, *, generator=None):
        k = self.kernel_size
        pad_l = (k - 1) // 2
        x = self.ffn_1(F.pad(x, (0, 0, pad_l, k - 1 - pad_l))) * k ** -0.5
        x = dropout(torch.relu(x), self.p_dropout, self.training, generator)
        return self.ffn_2(x)


class EncSALayer(nn.Module):
    """Pre-LN self-attention (no qkv bias, -inf key padding) + conv FFN."""

    def __init__(self, c: int, num_heads: int = 8, kernel_size: int = 9,
                 p_dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.p_dropout = num_heads, p_dropout
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.in_proj = nn.Linear(c, 3 * c, bias=False)
        self.out_proj = nn.Linear(c, c, bias=False)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.ffn = TransformerFFNLayer(c, 4 * c, kernel_size, p_dropout)

    def forward(self, x, keep_mask, *, generator=None):
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = self.in_proj(self.layer_norm1(x)).chunk(3, -1)

        def split(a):
            return a.reshape(b, t, self.num_heads, d).transpose(1, 2)

        scores = torch.matmul(split(q) * d ** -0.5, split(k).transpose(-1, -2))
        pad = keep_mask[:, None, None, :, 0] == 0
        p = torch.softmax(scores.masked_fill(pad, float("-inf")), dim=-1)
        out = torch.matmul(p, split(v)).transpose(1, 2).reshape(b, t, c)
        out = dropout(self.out_proj(out), self.p_dropout, self.training,
                      generator)
        x = (x + out) * keep_mask
        h = self.ffn(self.layer_norm2(x), generator=generator)
        h = dropout(h, self.p_dropout, self.training, generator)
        return (x + h) * keep_mask


# -- embeddings -------------------------------------------------------------

def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding [N, dim], cos first, frequency shift 0."""
    half = dim // 2
    exponent = -math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class AttentionPooling(nn.Module):
    """Class-token attention pooling, q and k scaled by d^-1/4."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads, self.embed_dim = num_heads, embed_dim
        self.positional_embedding = nn.Parameter(torch.zeros(1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        bs = x.shape[0]
        d = self.embed_dim // self.num_heads
        class_token = x.mean(dim=1, keepdim=True) + self.positional_embedding
        x_all = torch.cat([class_token, x], dim=1)

        def shape(t):
            return (t.reshape(bs, -1, self.num_heads, d).transpose(1, 2)
                    .reshape(bs * self.num_heads, -1, d))

        scale = 1 / math.sqrt(math.sqrt(d))
        q = shape(self.q_proj(class_token))
        k, v = shape(self.k_proj(x_all)), shape(self.v_proj(x_all))
        weight = torch.softmax(
            torch.matmul(q * scale, (k * scale).transpose(-1, -2)), dim=-1)
        return torch.matmul(weight, v).reshape(bs, self.embed_dim)


class TextTimeEmbedding(nn.Module):
    """LN -> AttentionPooling -> Linear -> LN."""

    def __init__(self, encoder_dim: int, time_embed_dim: int,
                 num_heads: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(encoder_dim, eps=1e-5)
        self.pool = AttentionPooling(num_heads, encoder_dim)
        self.proj = nn.Linear(encoder_dim, time_embed_dim)
        self.norm2 = nn.LayerNorm(time_embed_dim, eps=1e-5)

    def forward(self, hidden_states):
        return self.norm2(self.proj(self.pool(self.norm1(hidden_states))))


# -- flows and the spline ---------------------------------------------------

class Log(nn.Module):
    """y = log(max(x, 1e-5)) * mask, logdet = -sum(y); reverse exp."""

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    """Channel flip (logdet 0)."""

    def forward(self, x, *args, reverse: bool = False, **kwargs):
        x = torch.flip(x, dims=(-1,))
        if not reverse:
            return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return x


class ElementwiseAffine(nn.Module):
    """y = (m + exp(logs) * x) * mask."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask, reverse: bool = False, **kwargs):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling over a WN stack."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Linear(self.half, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = nn.Linear(hidden_channels, self.half)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        m = self.post(self.enc(self.pre(x0) * x_mask, x_mask, g=g)) * x_mask
        if not reverse:
            return torch.cat([x0, m + x1 * x_mask], dim=-1), \
                torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return torch.cat([x0, (x1 - m) * x_mask], dim=-1)


def _edges(unnormalized, lo, hi, min_frac):
    num_bins = unnormalized.shape[-1]
    frac = torch.softmax(unnormalized, dim=-1)
    frac = min_frac + (1 - min_frac * num_bins) * frac
    cum = (hi - lo) * torch.cumsum(frac, dim=-1)[..., :-1] + lo
    lo_t = torch.full_like(cum[..., :1], lo)
    return torch.cat([lo_t, cum, torch.full_like(lo_t, hi)], dim=-1)


def spline(inputs, uw, uh, ud, inverse: bool, tail_bound: float,
           min_bin: float = 1e-3, min_derivative: float = 1e-3):
    """The linear-tail rational-quadratic spline on [-B, B] (identity
    outside, log|det| 0 there) and its log|det J|."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    ud = F.pad(ud, (1, 1), value=constant)
    x = torch.clamp(inputs, -tail_bound, tail_bound)
    num_bins = uw.shape[-1]
    cumwidths = _edges(uw, -tail_bound, tail_bound, min_bin)
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    derivatives = min_derivative + F.softplus(ud)
    cumheights = _edges(uh, -tail_bound, tail_bound, min_bin)
    heights = cumheights[..., 1:] - cumheights[..., :-1]
    locs = cumheights if inverse else cumwidths
    locs = torch.cat([locs[..., :-1], locs[..., -1:] + 1e-6], dim=-1)
    idx = torch.sum(x[..., None] >= locs, dim=-1) - 1
    idx = torch.clamp(idx, 0, num_bins - 1)[..., None]

    def take(t):
        return torch.gather(t, -1, idx)[..., 0]

    cw, w, ch, h = take(cumwidths), take(widths), take(cumheights), \
        take(heights)
    delta = take(heights / widths)
    d0, d1 = take(derivatives), take(derivatives[..., 1:])
    s = d0 + d1 - 2 * delta
    if inverse:
        dy = x - ch
        a = dy * s + h * (delta - d0)
        b = h * d0 - dy * s
        c = -delta * dy
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(b ** 2 - 4 * a * c,
                                                      min=0.0)))
        out = root * w + cw
        tom = root * (1 - root)
        num = delta ** 2 * (d1 * root ** 2 + 2 * delta * tom
                            + d0 * (1 - root) ** 2)
        logdet = -(torch.log(num) - 2 * torch.log(delta + s * tom))
    else:
        theta = (x - cw) / w
        tom = theta * (1 - theta)
        out = ch + h * (delta * theta ** 2 + d0 * tom) / (delta + s * tom)
        num = delta ** 2 * (d1 * theta ** 2 + 2 * delta * tom
                            + d0 * (1 - theta) ** 2)
        logdet = torch.log(num) - 2 * torch.log(delta + s * tom)
    return (torch.where(inside, out, inputs),
            torch.where(inside, logdet, torch.zeros_like(logdet)))


class ConvFlow(nn.Module):
    """Rational-quadratic spline coupling over a DDSConv."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.half, self.num_bins = in_channels // 2, num_bins
        self.filter_channels, self.tail_bound = filter_channels, tail_bound
        self.pre = nn.Linear(self.half, filter_channels)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = nn.Linear(filter_channels,
                              self.half * (num_bins * 3 - 1))

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.proj(self.convs(self.pre(x0), x_mask, g=g)) * x_mask
        b, t, _ = x0.shape
        nb = self.num_bins
        h = h.reshape(b, t, self.half, nb * 3 - 1)
        scale = math.sqrt(self.filter_channels)
        x1, logabsdet = spline(x1, h[..., :nb] / scale,
                               h[..., nb:2 * nb] / scale, h[..., 2 * nb:],
                               reverse, self.tail_bound)
        x_out = torch.cat([x0, x1], dim=-1) * x_mask
        if reverse:
            return x_out
        return x_out, torch.sum(logabsdet * x_mask, dim=(1, 2))


# -- MAS --------------------------------------------------------------------

def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search. neg_cent, mask [B, Ty, Tx] -> the hard
    path [B, Ty, Tx], zero outside the mask."""
    nc = neg_cent.float()
    b, t_y_max, t_x_max = nc.shape
    t_ys = mask.sum(dim=1)[:, 0].to(torch.int64)
    t_xs = mask.sum(dim=2)[:, 0].to(torch.int64)
    x_idx = torch.arange(t_x_max, device=nc.device)[None, :]
    neg = -1e9
    prev = nc.new_zeros(b, t_x_max)
    values = []
    for y in range(t_y_max):
        v_cur = torch.where(x_idx == y, neg, prev)
        shifted = F.pad(prev[:, :-1], (1, 0))
        v_prev = torch.where(x_idx == 0, 0.0 if y == 0 else neg, shifted)
        acc = nc[:, y] + torch.maximum(v_cur, v_prev)
        lower = torch.clamp(t_xs + y - t_ys, min=0)[:, None]
        upper = torch.clamp(t_xs, max=y + 1)[:, None]
        prev = torch.where((x_idx >= lower) & (x_idx < upper), acc, nc[:, y])
        values.append(prev)
    index = t_xs - 1
    rows = []
    for y in range(t_y_max - 1, -1, -1):
        active = y < t_ys
        rows.append((active[:, None] & (x_idx == index[:, None])).float())
        row_prev = values[max(y - 1, 0)]
        v_at = row_prev.gather(1, index.clamp(min=0)[:, None])[:, 0]
        v_left = row_prev.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        move = (index != 0) & ((index == y) | (v_at < v_left))
        index = torch.where(active & move, index - 1, index)
    return torch.stack(rows[::-1], dim=1) * mask.float()
