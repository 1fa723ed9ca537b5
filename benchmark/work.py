"""The work arithmetic: the operations and bytes of every product the
model's calls make, worked out from shapes and configuration widths, and
the published peaks of one NVIDIA H100 SXM.

Each product (a linear layer, a convolution, a batched matrix product of
two activations) is an ``Op``: its floating-point operations (2 per
multiply-add, as ``torch.utils.flop_counter`` counts them), the bytes it
must at least move (each operand read once and the result written once),
and what its backward computes: a weight's gradient, an input's gradient,
both or neither. Elementwise work, norms, softmax, FFTs and lookups are
not counted: they only lower the floor a roofline share is taken against.

``roofline_s`` is the least time the card could take over a list of ops:
the sum over ops of the larger of operations over the bf16 dense peak and
bytes over the memory bandwidth.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, H100 SXM
PEAK_BYTES_S = 3.35e12       # HBM3, H100 SXM


@dataclasses.dataclass(frozen=True)
class Op:
    flops: float
    bytes: float
    weight: bool = True      # one operand is a parameter (its gradient)
    grad_in: bool = True     # the activation operand(s) need a gradient
    operands: int = 1        # activation operands (2: attention products)

    def backward_flops(self) -> float:
        """Operations of the backward: one product of the forward's size
        for the weight's gradient and one for each activation's."""
        n = (1 if self.weight else 0) + (self.operands if self.grad_in
                                         else 0)
        return n * self.flops


def linear(m: int, k: int, n: int, s: int, *, grad_in=True) -> Op:
    """[m, k] @ [k, n]."""
    return Op(2.0 * m * k * n, s * (m * k + k * n + m * n), True, grad_in)


def conv(b: int, t_in: int, t_out: int, c_in: int, c_out: int, k: int,
         s: int, groups: int = 1, *, grad_in=True) -> Op:
    per = c_in // groups * k
    return Op(2.0 * b * t_out * c_out * per,
              s * (b * t_in * c_in + c_out * per + b * t_out * c_out),
              True, grad_in)


def bmm(b: int, m: int, k: int, n: int, s: int, *, operands=2,
        grad_in=True) -> Op:
    """b products [m, k] @ [k, n] of activations."""
    return Op(2.0 * b * m * k * n, s * b * (m * k + k * n + m * n), False,
              grad_in, operands)


def total_flops(ops: Iterable[Op]) -> float:
    return sum(o.flops for o in ops)


def train_flops(ops: Iterable[Op]) -> float:
    """Forward and backward operations of a training step."""
    return sum(o.flops + o.backward_flops() for o in ops)


def roofline_s(ops: Iterable[Op]) -> float:
    return sum(max(o.flops / PEAK_FLOPS, o.bytes / PEAK_BYTES_S) for o in ops)


def train_ops(ops: Iterable[Op]) -> List[Op]:
    """A training step's ops as the roofline counts them: each forward op,
    and its backward as products of the forward's size and bytes."""
    out = []
    for o in ops:
        out.append(o)
        n = round(o.backward_flops() / o.flops) if o.flops else 0
        out += [dataclasses.replace(o, weight=False, grad_in=False)] * n
    return out


# -- the model's parts ---------------------------------------------------------

def _down(t: int) -> int:
    return (t - 1) // 2 + 1      # k3, stride 2, padding 1


def pooling(b: int, s_len: int, dim: int, heads: int, out: int, s: int,
            grad_in=True) -> List[Op]:
    """TextTimeEmbedding: attention pooling over [b, s_len, dim] with a
    class token, then Linear(dim, out)."""
    d = dim // heads
    return [linear(b, dim, dim, s, grad_in=grad_in),
            linear(b * (s_len + 1), dim, dim, s, grad_in=grad_in),
            linear(b * (s_len + 1), dim, dim, s, grad_in=grad_in),
            bmm(b * heads, 1, d, s_len + 1, s, grad_in=grad_in),
            bmm(b * heads, 1, s_len + 1, d, s, grad_in=grad_in),
            linear(b, dim, out, s, grad_in=grad_in)]


def unet(b: int, t: int, s_ctx: int, c_in: int, c_out: int, ch, heads: int,
         ctx_dim: int, s: int, *, embed: bool = True, layers: int = 2,
         grad_in=True) -> List[Op]:
    """One UNet1DConditionModel call on [b, t, c_in] with a [b, s_ctx,
    ctx_dim] context; ``embed``: the call embeds its timesteps and pools
    its context itself (no injected embedding)."""
    ch = tuple(ch)
    n = len(ch)
    temb = 4 * ch[0]
    ops: List[Op] = []
    if embed:
        ops += [linear(b, ch[0], temb, s, grad_in=False),
                linear(b, temb, temb, s)]
        ops += pooling(b, s_ctx, ctx_dim, min(64, ctx_dim), temb, s)

    def resnet(cin, cout, tt):
        out = [conv(b, tt, tt, cin, cout, 3, s), linear(b, temb, 2 * cout, s),
               conv(b, tt, tt, cout, cout, 3, s)]
        if cin != cout:
            out.append(linear(b * tt, cin, cout, s))
        return out

    def transformer(c, tt):
        d = c // heads
        return [linear(b * tt, c, c, s),
                linear(b * tt, c, c, s), linear(b * tt, c, c, s),
                linear(b * tt, c, c, s), bmm(b * heads, tt, d, tt, s),
                bmm(b * heads, tt, tt, d, s), linear(b * tt, c, c, s),
                linear(b * tt, c, c, s), linear(b * s_ctx, ctx_dim, c, s),
                linear(b * s_ctx, ctx_dim, c, s),
                bmm(b * heads, tt, d, s_ctx, s),
                bmm(b * heads, tt, s_ctx, d, s), linear(b * tt, c, c, s),
                linear(b * tt, c, 8 * c, s), linear(b * tt, 4 * c, c, s),
                linear(b * tt, c, c, s)]

    ts = [t]
    for _ in range(n - 1):
        ts.append(_down(ts[-1]))
    ops.append(conv(b, t, t, c_in, ch[0], 3, s, grad_in=grad_in))
    for i in range(n):
        cin = ch[max(i - 1, 0)]
        for j in range(layers):
            ops += resnet(cin if j == 0 else ch[i], ch[i], ts[i])
            if i < n - 1:
                ops += transformer(ch[i], ts[i])
        if i < n - 1:
            ops.append(conv(b, ts[i], ts[i + 1], ch[i], ch[i], 3, s))
    ops += resnet(ch[-1], ch[-1], ts[-1]) + transformer(ch[-1], ts[-1]) \
        + resnet(ch[-1], ch[-1], ts[-1])
    rev = list(reversed(ch))
    prev = rev[0]
    for i in range(n):
        out_ch, in_ch = rev[i], rev[min(i + 1, n - 1)]
        tt = ts[n - 1 - i]
        for j in range(layers + 1):
            skip = in_ch if j == layers else out_ch
            ops += resnet((prev if j == 0 else out_ch) + skip, out_ch, tt)
            if i > 0:
                ops += transformer(out_ch, tt)
        if i < n - 1:
            t_up = ts[n - 2 - i]
            ops.append(conv(b, t_up, t_up, out_ch, out_ch, 3, s))
        prev = out_ch
    ops.append(conv(b, t, t, ch[0], c_out, 3, s))
    return ops


def rel_encoder(b: int, t: int, h: int, filt: int, heads: int, layers: int,
                k: int, gin: int, s: int, window: int = 4) -> List[Op]:
    """The VITS relative-position encoder (its speaker linear included)."""
    d = h // heads
    w = 2 * min(window, t - 1) + 1
    ops = [linear(b, gin, h, s)] if gin and layers > 2 else []
    for _ in range(layers):
        ops += [linear(b * t, h, h, s), linear(b * t, h, h, s),
                linear(b * t, h, h, s), bmm(b * heads, t, d, t, s),
                bmm(b * heads * t, 1, d, w, s), bmm(b * heads, t, t, d, s),
                bmm(b * heads * t, 1, w, d, s), linear(b * t, h, h, s),
                conv(b, t, t, h, filt, k, s), conv(b, t, t, filt, h, k, s)]
    return ops


def text_encoder(b, t, v, s) -> List[Op]:
    return rel_encoder(b, t, v.hidden_channels, v.filter_channels, v.n_heads,
                       v.n_layers, v.kernel_size, v.gin_channels, s) + \
        [linear(b * t, v.hidden_channels, 2 * v.inter_channels, s)]


def prompt_encoder(b, t, c_in, hidden, c_out, layers, s, *, gin=None,
                   grad_in=True) -> List[Op]:
    """PromptEncoder: k1 conv, ``layers`` x EncSALayer (8 heads, FFN k9),
    k1 conv."""
    ops = [linear(b, gin, c_in, s)] if gin else []
    ops.append(conv(b, t, t, c_in, hidden, 1, s, grad_in=grad_in))
    d = hidden // 8
    for _ in range(layers):
        ops += [linear(b * t, hidden, 3 * hidden, s),
                bmm(b * 8, t, d, t, s), bmm(b * 8, t, t, d, s),
                linear(b * t, hidden, hidden, s),
                conv(b, t, t, hidden, 4 * hidden, 9, s),
                linear(b * t, 4 * hidden, hidden, s)]
    return ops + [conv(b, t, t, hidden, c_out, 1, s)]


def wn(b, t, h, k, layers, gin, s) -> List[Op]:
    ops = [linear(b, gin, 2 * h * layers, s)] if gin else []
    for i in range(layers):
        ops += [conv(b, t, t, h, 2 * h, k, s),
                linear(b * t, h, 2 * h if i < layers - 1 else h, s)]
    return ops


def dds(b, t, c, layers, k, s) -> List[Op]:
    ops = []
    for _ in range(layers):
        ops += [conv(b, t, t, c, c, k, s, groups=c), linear(b * t, c, c, s)]
    return ops


def conv_flow(b, t, c, s, bins=10) -> List[Op]:
    return [linear(b * t, 1, c, s)] + dds(b, t, c, 3, 3, s) + \
        [linear(b * t, c, 3 * bins - 1, s)]


def sdp(b, t, v, s, *, reverse: bool) -> List[Op]:
    """The stochastic duration predictor: reverse (three ConvFlows) or
    forward (its NLL: the posterior's and the prior's flows)."""
    c, gin = v.hidden_channels, v.gin_channels
    ops = [linear(b * t, c, c, s, grad_in=False), linear(b, gin, c, s,
                                                         grad_in=False)]
    ops += dds(b, t, c, 3, 3, s) + [linear(b * t, c, c, s)]
    if reverse:
        return ops + 3 * conv_flow(b, t, c, s)
    ops += [linear(b * t, 1, c, s, grad_in=False)] + dds(b, t, c, 3, 3, s) \
        + [linear(b * t, c, c, s)]
    return ops + 8 * conv_flow(b, t, c, s)


def flow(b, t, v, s) -> List[Op]:
    """The residual-coupling flow, either way."""
    half, h = v.inter_channels // 2, v.hidden_channels
    one = [linear(b * t, half, h, s)] + wn(b, t, h, 5, 4, v.gin_channels, s) \
        + [linear(b * t, h, half, s)]
    return v.n_flow_layer * one


def duration(b, t_x, s_prompt, v, s, *, train: bool) -> List[Op]:
    """The duration predictor's call (reverse at inference)."""
    if v.duration_predictor == "sdp":
        return sdp(b, t_x, v, s, reverse=not train)
    h = 256
    return [linear(b * s_prompt, v.posterior_in_channels, h, s,
                   grad_in=False),
            linear(b * t_x, v.hidden_channels, h, s, grad_in=False)] + \
        unet(b, t_x, s_prompt, h, 1, (h // 4, h // 4, h // 2, h // 2), 8, h,
             s)


def o_proj(b, t, v, s) -> List[Op]:
    return prompt_encoder(b, t, v.inter_channels, v.hidden_channels,
                          v.inter_channels, 6, s, gin=v.gin_channels)


def predict_lengths(cfg, b, t_x, s_prompt, s) -> List[Op]:
    """The duration pass: speaker pooling, text encoder, durations."""
    v = cfg.vits
    return pooling(b, s_prompt, v.posterior_in_channels, 1, v.gin_channels,
                   s) + text_encoder(b, t_x, v, s) + \
        duration(b, t_x, s_prompt, v, s, train=False)


def synthesize(cfg, b, t_x, t_y, s_prompt, s, steps: int = 30) -> List[Op]:
    """One ``synthesize`` call: the prior, the prompt encoder, the
    embeddings of the steps' times and of the prompt, and ``steps`` UNet
    calls."""
    v, d = cfg.vits, cfg.diffusion_encoder
    ops = predict_lengths(cfg, b, t_x, s_prompt, s)
    ops += [bmm(b, t_y, t_x, v.inter_channels, s)] * 2
    if v.use_flow:
        ops += flow(b, t_y, v, s)
    ops += o_proj(b, t_y, v, s)
    ops += prompt_encoder(b, s_prompt, d.in_channels, d.hidden_channels,
                          d.hidden_channels, d.n_prompt_layers, s)
    ch = d.block_out_channels
    ops += [linear(steps + 1, ch[0], 4 * ch[0], s),
            linear(steps + 1, 4 * ch[0], 4 * ch[0], s)]
    ops += pooling(b, s_prompt, d.hidden_channels, min(64, d.hidden_channels),
                   4 * ch[0], s)
    one = unet(b, t_y, s_prompt, d.in_channels + v.inter_channels,
               d.out_channels, ch, d.n_heads, d.hidden_channels, s,
               embed=False)
    return ops + steps * one


def vocoder(b, t, s, n_mels=100, dim=512, inter=1536, layers=8,
            n_fft=1024) -> List[Op]:
    ops = [conv(b, t, t, n_mels, dim, 7, s)]
    for _ in range(layers):
        ops += [conv(b, t, t, dim, dim, 7, s, groups=dim),
                linear(b * t, dim, inter, s), linear(b * t, inter, dim, s)]
    return ops + [linear(b * t, dim, n_fft + 2, s)]


def train_forward(cfg, b, t_x, t_y, s_prompt, s) -> List[Op]:
    """The training loss's forward at [b, t_x] texts, [b, t_y] mels and
    [b, s_prompt] prompts."""
    v, d = cfg.vits, cfg.diffusion_encoder
    c_mel, h, inter = v.posterior_in_channels, v.hidden_channels, \
        v.inter_channels
    ops = pooling(b, t_y, c_mel, 1, v.gin_channels, s)
    ops += text_encoder(b, t_x, v, s)
    ops += [linear(b * t_y, c_mel, h, s, grad_in=False)] + \
        wn(b, t_y, h, v.posterior_kernel_size, v.posterior_n_layers,
           v.gin_channels, s) + [linear(b * t_y, h, 2 * inter, s)]
    if v.use_flow:
        ops += flow(b, t_y, v, s)
    no_grad = dataclasses.replace(bmm(b, t_y, inter, t_x, s), weight=False,
                                  grad_in=False)
    ops += [no_grad, no_grad]
    ops += duration(b, t_x, t_y, v, s, train=True)
    ops += [bmm(b, t_y, t_x, inter, s, operands=1)] * 2
    ops += o_proj(b, t_y, v, s)
    ops += prompt_encoder(b, s_prompt, d.in_channels, d.hidden_channels,
                          d.hidden_channels, d.n_prompt_layers, s)
    return ops + unet(b, t_y, s_prompt, d.in_channels + inter,
                      d.out_channels, d.block_out_channels, d.n_heads,
                      d.hidden_channels, s)


def share(floor_s: float, busy_s: float) -> float:
    """A floor's share of the busy time, in percent."""
    return 100.0 * floor_s / busy_s if busy_s > 0 else math.nan
