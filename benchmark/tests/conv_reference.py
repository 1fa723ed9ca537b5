"""A plain reference that the frozen one refuses, added as files only:
``model3`` with the classic VITS conv duration predictor
(``duration_predictor: "conv"``, the port's ``models/duration.py
DurationPredictor``), every other layer reused from the frozen reference.

It shows what a new architecture brings: a reference module with the
names ``benchmark.references`` asks for (``Config``, ``DiffVits``,
``synthesize``, ``Vocos``, ``maximum_path``, ``work``). Tests install it
under ``benchmark.reference.*`` (``install``), so that nothing of it lands
in the frozen package; a configuration names it under ``"reference"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from benchmark import work as bw
from benchmark.reference import draws, layers, model
from benchmark.reference.config import Config
from benchmark.reference.layers import generate_path, maximum_path, \
    sequence_mask
from benchmark.reference.model import synthesize
from benchmark.reference.vocos import Vocos

NAME = "benchmark.reference.conv_duration"
__all__ = ["Config", "DiffVits", "synthesize", "Vocos", "maximum_path",
           "work"]


def install(monkeypatch) -> str:
    """This module as ``benchmark.reference.conv_duration`` for the test's
    length; returns the name."""
    import sys
    monkeypatch.setitem(sys.modules, NAME, sys.modules[__name__])
    return NAME


class DurationPredictor(nn.Module):
    """Two (k-conv, ReLU, LayerNorm, dropout) stages and a 1-channel
    projection over the detached text encoding, the speaker embedding
    added first."""

    def __init__(self, in_channels, filter_channels, kernel_size, p_dropout,
                 gin_channels):
        super().__init__()
        self.p_dropout = p_dropout
        self.cond = nn.Linear(gin_channels, in_channels)
        pad = kernel_size // 2
        self.conv_1 = layers.Conv1d(in_channels, filter_channels, kernel_size,
                                    padding=pad)
        self.norm_1 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.conv_2 = layers.Conv1d(filter_channels, filter_channels,
                                    kernel_size, padding=pad)
        self.norm_2 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.proj = nn.Linear(filter_channels, 1)

    def forward(self, x, x_mask, g, *, generator=None):
        x = x.detach() + self.cond(g.detach())
        for conv, norm in ((self.conv_1, self.norm_1),
                           (self.conv_2, self.norm_2)):
            x = norm(torch.relu(conv(x * x_mask)))
            x = layers.dropout(x, self.p_dropout, self.training, generator)
        return self.proj(x * x_mask) * x_mask


class VITS(model.VITS):
    """The frozen VITS with the conv predictor as ``dp``."""

    def __init__(self, n_vocab: int, c):
        super().__init__(n_vocab,
                         dataclasses.replace(c, duration_predictor="unet"))
        if c.duration_predictor != "conv":
            raise ValueError("this reference holds the conv predictor")
        self.cfg = c
        self.dp = DurationPredictor(c.hidden_channels, 256, 3, 0.5,
                                    c.gin_channels)

    def forward(self, x, x_lengths, y, y_lengths, tone, language, *,
                generator, mas_noise_scale: float, mas_std: torch.Tensor,
                n_text: torch.Tensor, n_frames: torch.Tensor,
                path: Optional[torch.Tensor] = None):
        nc, (g, x_h, m_p, logs_p, x_mask, z, logs_q, y_mask, z_p) = \
            self.neg_cent(x, x_lengths, y, y_lengths, tone, language,
                          generator=generator)
        attn_mask = y_mask[:, :, 0][:, :, None] * x_mask[:, :, 0][:, None, :]
        with torch.no_grad():
            noise = draws.randn(nc.shape, generator, nc.device)
            if path is None:
                nc = nc + mas_std * noise * mas_noise_scale
                attn = maximum_path(nc.contiguous(), attn_mask.float())
            else:
                attn = path.to(nc.device, torch.float32)
        w = attn.sum(dim=1)
        logw_ = torch.log(w + 1e-6)[..., None] * x_mask
        logw = self.dp(x_h, x_mask, g, generator=generator)
        l_length = torch.sum(torch.sum((logw - logw_) ** 2, dim=(1, 2))
                             / n_text)
        m_p_e = torch.matmul(attn, m_p.float())
        logs_p_e = torch.matmul(attn, logs_p.float())
        kl = logs_p_e - logs_q.float() - 0.5
        kl = kl + 0.5 * (z_p.float() - m_p_e) ** 2 * torch.exp(-2.0 * logs_p_e)
        loss_kl = torch.sum(kl * y_mask.float()) / n_frames
        content = self.o_proj(z, y_lengths, g=g, generator=generator)
        return content, (l_length, loss_kl), attn

    def infer(self, x, x_lengths, y, y_lengths, tone, language, *,
              noise_scale: float, length_scale: float, max_len: int,
              generator, w_ceil: Optional[torch.Tensor] = None,
              out_lengths: Optional[torch.Tensor] = None):
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g)
        logw = self.dp(x_h, x_mask, g)
        if w_ceil is None:
            w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)[..., 0]
        if out_lengths is None:
            out_lengths = torch.clamp(w_ceil.sum(dim=-1), min=1.0).to(
                torch.int32)
        out_lengths = torch.clamp(out_lengths, max=max_len)
        y_mask = sequence_mask(out_lengths, max_len).to(x_mask.dtype)
        attn = generate_path(w_ceil.to(x_mask.dtype),
                             y_mask[:, :, None] * x_mask[:, None, :, 0])
        m_p_e = torch.matmul(attn, m_p)
        logs_p_e = torch.matmul(attn, logs_p)
        z_p = m_p_e
        if noise_scale != 0.0:
            noise = draws.normal_like(m_p_e.shape, m_p_e, generator)
            z_p = m_p_e + noise * torch.exp(logs_p_e) * noise_scale
        if self.flow is not None:
            y_keep = y_mask[..., None]
            z_p = self.flow(z_p, y_keep, g=g, reverse=True) * y_keep
        return self.o_proj(z_p, out_lengths, g=g), out_lengths, logw


class DiffVits(model.DiffVits):
    def __init__(self, cfg: Config, n_vocab: int):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.vits = VITS(n_vocab, cfg.vits)
        self.diff_model = model.DiffusionEncoder(cfg.diffusion_encoder,
                                                 cfg.vits.inter_channels)


def _duration(b, t_x, v, s) -> List[bw.Op]:
    h, f = v.hidden_channels, 256
    return [bw.linear(b, v.gin_channels, h, s, grad_in=False),
            bw.conv(b, t_x, t_x, h, f, 3, s), bw.conv(b, t_x, t_x, f, f, 3, s),
            bw.linear(b * t_x, f, 1, s)]


class work:
    """``benchmark.work``'s count with the conv predictor's products in
    place of the UNet predictor's."""

    vocoder = staticmethod(bw.vocoder)

    @staticmethod
    def predict_lengths(cfg, b, t_x, s_prompt, s) -> List[bw.Op]:
        v = cfg.vits
        return bw.pooling(b, s_prompt, v.posterior_in_channels, 1,
                          v.gin_channels, s) + \
            bw.text_encoder(b, t_x, v, s) + _duration(b, t_x, v, s)

    @staticmethod
    def synthesize(cfg, b, t_x, t_y, s_prompt, s, steps: int = 30
                   ) -> List[bw.Op]:
        v, d = cfg.vits, cfg.diffusion_encoder
        ops = work.predict_lengths(cfg, b, t_x, s_prompt, s)
        ops += [bw.bmm(b, t_y, t_x, v.inter_channels, s)] * 2
        if v.use_flow:
            ops += bw.flow(b, t_y, v, s)
        ops += bw.o_proj(b, t_y, v, s)
        ops += bw.prompt_encoder(b, s_prompt, d.in_channels,
                                 d.hidden_channels, d.hidden_channels,
                                 d.n_prompt_layers, s)
        ch = d.block_out_channels
        ops += [bw.linear(steps + 1, ch[0], 4 * ch[0], s),
                bw.linear(steps + 1, 4 * ch[0], 4 * ch[0], s)]
        ops += bw.pooling(b, s_prompt, d.hidden_channels,
                          min(64, d.hidden_channels), 4 * ch[0], s)
        return ops + steps * bw.unet(
            b, t_y, s_prompt, d.in_channels + v.inter_channels,
            d.out_channels, ch, d.n_heads, d.hidden_channels, s, embed=False)

    @staticmethod
    def train_forward(cfg, b, t_x, t_y, s_prompt, s) -> List[bw.Op]:
        v, d = cfg.vits, cfg.diffusion_encoder
        c_mel, h, inter = v.posterior_in_channels, v.hidden_channels, \
            v.inter_channels
        ops = bw.pooling(b, t_y, c_mel, 1, v.gin_channels, s)
        ops += bw.text_encoder(b, t_x, v, s)
        ops += [bw.linear(b * t_y, c_mel, h, s, grad_in=False)] + \
            bw.wn(b, t_y, h, v.posterior_kernel_size, v.posterior_n_layers,
                  v.gin_channels, s) + [bw.linear(b * t_y, h, 2 * inter, s)]
        if v.use_flow:
            ops += bw.flow(b, t_y, v, s)
        no_grad = dataclasses.replace(bw.bmm(b, t_y, inter, t_x, s),
                                      weight=False, grad_in=False)
        ops += [no_grad, no_grad]
        ops += _duration(b, t_x, v, s)
        ops += [bw.bmm(b, t_y, t_x, inter, s, operands=1)] * 2
        ops += bw.o_proj(b, t_y, v, s)
        ops += bw.prompt_encoder(b, s_prompt, d.in_channels,
                                 d.hidden_channels, d.hidden_channels,
                                 d.n_prompt_layers, s)
        return ops + bw.unet(b, t_y, s_prompt, d.in_channels + inter,
                             d.out_channels, d.block_out_channels, d.n_heads,
                             d.hidden_channels, s)
