"""Duration predictors: UNet-conditioned (model3), classic conv, and
stochastic (flow-based).

Port of ``DurationPredictorUNet``, ``DurationPredictor`` and
``StochasticDurationPredictor`` of ``diff_vits_tpu/models/duration.py``
(:22-59, :62-89, :92-185): text hidden (+ prompt mel or speaker
embedding) -> log durations. Their inputs are detached, as the JAX modules
stop their gradients: the duration loss trains the predictor alone.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.core import masking, trace
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.nn.flows import ConvFlow, ElementwiseAffine, Flip, Log
from diff_vits_tpu_torch.nn.layers import Conv1d, DDSConv, dropout
from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
from diff_vits_tpu_torch.parallel import activations


class DurationPredictorUNet(nn.Module):
    """block_out = (h/4, h/4, h/2, h/2), 8 groups, cross-attention width h,
    8 heads, 'text' additive embedding."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 prompt_channels: int, out_channels: int = 1,
                 n_heads: int = 8, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        h = hidden_channels
        self.prompt_proj = nn.Linear(prompt_channels, h)
        self.pre = nn.Linear(in_channels, h)
        self.enc = UNet1DConditionModel(
            in_channels=h, out_channels=out_channels,
            block_out_channels=(h // 4, h // 4, h // 2, h // 2),
            norm_num_groups=8, cross_attention_dim=h,
            attention_head_dim=n_heads, addition_embed_type="text",
            device=device, dtype=dtype)
        self.to(device=device, dtype=dtype)

    def forward(self, x, x_lengths, prompt, prompt_lengths):
        x, prompt = x.detach(), prompt.detach()
        prompt = self.prompt_proj(prompt)
        x_mask = masking.sequence_mask(x_lengths, x.shape[1]).to(
            x.dtype)[..., None]
        prompt_keep = masking.sequence_mask(prompt_lengths, prompt.shape[1])
        prompt = prompt * prompt_keep.to(prompt.dtype)[..., None]
        x = self.pre(x) * x_mask
        # whole on every rank under sequence parallelism, which shards the
        # diffusion UNet only
        with activations.sequence_parallel(None):
            out = self.enc(x, torch.ones((), dtype=torch.int32), prompt,
                           encoder_attention_mask=prompt_keep)
        return out * x_mask


class DurationPredictor(nn.Module):
    """Classic VITS conv duration predictor: two (k-conv, ReLU, LayerNorm,
    dropout) stages and a 1-channel projection, speaker embedding added
    first (duration.py:62-89)."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, gin_channels: int = 0,
                 *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.p_dropout = p_dropout
        self.cond = nn.Linear(gin_channels, in_channels) if gin_channels \
            else None
        pad = kernel_size // 2
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_1 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_2 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.proj = nn.Linear(filter_channels, 1)
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x, x_mask, g=None, *,
                generator: Optional[torch.Generator] = None):
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        for conv, norm in ((self.conv_1, self.norm_1),
                           (self.conv_2, self.norm_2)):
            x = norm(torch.relu(conv(x * x_mask)))
            x = dropout(x, self.p_dropout, self.training, generator)
        return self.proj(x * x_mask) * x_mask


def draw_normal(shape, like, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
    """A float32 standard normal draw from ``generator`` (its device; the
    global CPU stream without one), moved to ``like``: a tensor, whose
    device and dtype it takes, or a device. One ``dvt.noise`` span of the
    port's tracer (``core.trace``); elements drawn on the host for another
    device count as ``noise.host_elements``."""
    dev = generator.device if generator is not None else torch.device("cpu")
    with trace.span("dvt.noise", elements=math.prod(shape), device=dev):
        out = torch.randn(shape, generator=generator, device=dev,
                          dtype=torch.float32).to(like)
    if dev.type == "cpu" and out.device.type != "cpu":
        trace.count("noise.host_elements", out.numel())
    return out


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration predictor (duration.py:92-185). The forward
    (``reverse=False``) returns the duration NLL [B] of ``w``; the reverse
    samples log durations [B, T, 1].

    As in the JAX module: the filter width is ``in_channels`` whatever
    ``filter_channels`` says (:109); the reverse runs the flows reversed
    with the second-to-last step of that order, ``flow_0``, dropped
    (:176-179; the JAX comment calls it the last Flip), so it runs three
    ConvFlow reverses; its latent is ``noise * noise_scale``. Each
    direction takes its Gaussian draw as a tensor (``noise`` [B, T, 2],
    the standard normal draw e_q of the forward or z of the reverse before
    scaling) or draws it from ``generator``."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, n_flows: int = 4,
                 gin_channels: int = 0, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        fc = in_channels
        self.n_flows = n_flows
        self.pre = nn.Linear(in_channels, fc)
        self.cond = nn.Linear(gin_channels, fc) if gin_channels else None
        self.convs = DDSConv(fc, kernel_size, 3, p_dropout=p_dropout)
        self.proj = nn.Linear(fc, fc)
        self.flow_pre = ElementwiseAffine(2)
        self.post_pre = nn.Linear(1, fc)
        self.post_convs = DDSConv(fc, kernel_size, 3, p_dropout=p_dropout)
        self.post_proj = nn.Linear(fc, fc)
        self.post_flow_pre = ElementwiseAffine(2)
        for prefix, n in (("flow", n_flows), ("post_flow", 4)):
            for i in range(n):
                self.add_module(f"{prefix}_{i}",
                                ConvFlow(2, fc, kernel_size, 3))
                self.add_module(f"{prefix}_flip_{i}", Flip())
        self.log_flow = Log()
        self.to(device=resolve_device(device), dtype=dtype)

    def _flows(self, prefix: str, n: int):
        steps = [getattr(self, f"{prefix}_pre")]
        for i in range(n):
            steps += [getattr(self, f"{prefix}_{i}"),
                      getattr(self, f"{prefix}_flip_{i}")]
        return steps

    def forward(self, x, x_mask, w=None, g=None, reverse: bool = False,
                noise_scale: float = 1.0, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = self.pre(x.detach())
        if g is not None and self.cond is not None:
            x = x + self.cond(g.detach())
        x = self.convs(x, x_mask, generator=generator)
        x = self.proj(x) * x_mask
        shape = (x.shape[0], x.shape[1], 2)

        if reverse:
            steps = self._flows("flow", self.n_flows)[::-1]
            steps = steps[:-2] + steps[-1:]
            if noise is None:
                noise = draw_normal(shape, x, generator)
            z = noise.to(x) * noise_scale
            for step in steps:
                z = step(z, x_mask, g=x, reverse=True)
            return z[..., :1]

        if w is None:
            raise ValueError("the forward (the NLL) needs the durations w")
        h_w = self.post_convs(self.post_pre(w), x_mask, generator=generator)
        h_w = self.post_proj(h_w) * x_mask
        if noise is None:
            noise = draw_normal(shape, w, generator)
        e_q = noise.to(w) * x_mask
        z_q, logdet_q = e_q, 0.0
        for step in self._flows("post_flow", 4):
            z_q, logdet = step(z_q, x_mask, g=x + h_w)
            logdet_q = logdet_q + logdet
        z_u, z1 = z_q[..., :1], z_q[..., 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_q = logdet_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        log_2pi = math.log(2 * math.pi)
        logq = torch.sum(-0.5 * (log_2pi + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_q

        z0, logdet_tot = self.log_flow(z0, x_mask)
        z = torch.cat([z0, z1], dim=-1)
        for step in self._flows("flow", self.n_flows):
            z, logdet = step(z, x_mask, g=x)
            logdet_tot = logdet_tot + logdet
        nll = torch.sum(0.5 * (log_2pi + z ** 2) * x_mask,
                        dim=(1, 2)) - logdet_tot
        return nll + logq
