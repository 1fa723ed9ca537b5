"""bv2's VITS prior: the frozen reference's, with the phoneme-level
prosody VAE (``vits.phoneme_vae``) added to the frame latent before
``o_proj``, at inference and in the training loss."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from benchmark.reference import draws, model
from benchmark.reference.layers import (
    EncSALayer, generate_path, maximum_path, sequence_mask)
from benchmark.reference.model import ResidualCouplingBlock


class PhEncoder(nn.Module):
    """The phoneme posterior (bv2.py:540 ``Ph_Encoder``): Linear, Linear ->
    (m, logs) -> a sample. Training only."""

    def __init__(self, channels: int):
        super().__init__()
        self.pre = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, 2 * channels)

    def forward(self, x, x_mask, *, generator):
        h = self.pre(x) * x_mask
        m, logs = (self.proj(h) * x_mask).chunk(2, dim=-1)
        noise = draws.randn(m.shape, generator, m.device)
        return (m + noise * torch.exp(logs)) * x_mask, logs


class PhPriorEncoder(nn.Module):
    """The phoneme prior over the text encoder's hiddens (bv2.py:563
    ``Ph_p_encoder``): Linear, four pre-LN ``EncSALayer`` (8 heads, FFN
    kernel 9, dropout 0.2), Linear -> (m, logs)."""

    def __init__(self, hidden_channels: int, out_channels: int,
                 n_layers: int = 4):
        super().__init__()
        self.n_layers = n_layers
        self.pre = nn.Linear(hidden_channels, hidden_channels)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncSALayer(hidden_channels, 8, 9,
                                                     p_dropout=0.2))
        self.proj = nn.Linear(hidden_channels, 2 * out_channels)

    def forward(self, x, x_mask, *, generator=None):
        h = self.pre(x) * x_mask
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, x_mask, generator=generator)
        return (self.proj(h) * x_mask).chunk(2, dim=-1)


class PhonemeVAE(nn.Module):
    """Posterior, flow (bv2.py:697 ``phoneme_flow``: four residual
    couplings of ``n_flow_layer`` WN layers, kernel 5) and prior of the
    phoneme prosody, over the text positions."""

    def __init__(self, inter_channels: int, hidden_channels: int,
                 n_flow_layer: int, gin_channels: int):
        super().__init__()
        self.ph_encoder_q = PhEncoder(inter_channels)
        self.phoneme_flow = ResidualCouplingBlock(
            inter_channels, hidden_channels, 5, 1, n_flow_layer, 4,
            gin_channels)
        self.ph_enc_p = PhPriorEncoder(hidden_channels, inter_channels)

    def forward(self, z, attn, x_h, x_mask, g, *, generator, n_text):
        """Training: (the prosody [B, Ty, C] to add to the frame latent
        ``z``, the phoneme KL over the whole batch's ``n_text`` tokens).
        ``attn`` [B, Ty, Tx] is the MAS path."""
        counts = attn.sum(dim=1)
        z_ph = torch.matmul(attn.transpose(1, 2), z) / torch.clamp(
            counts, min=1.0)[..., None]
        z_q, logs_q = self.ph_encoder_q(z_ph, x_mask, generator=generator)
        z_p = self.phoneme_flow(z_q, x_mask, g=g)
        m_p, logs_p = self.ph_enc_p(x_h, x_mask, generator=generator)
        kl = logs_p - logs_q - 0.5
        kl = kl + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
        return torch.matmul(attn, z_q), torch.sum(kl * x_mask) / n_text

    def infer(self, attn, x_h, x_mask, g, *, noise_scale: float, generator):
        """The prior sample m + noise * exp(logs) * noise_scale (the noise
        not drawn at noise_scale 0), the flow reversed, expanded to the
        frames of ``attn``."""
        m, logs = self.ph_enc_p(x_h, x_mask)
        ph = m
        if noise_scale != 0.0:
            ph = m + draws.normal_like(m.shape, m, generator) \
                * torch.exp(logs) * noise_scale
        return torch.matmul(attn, self.phoneme_flow(ph, x_mask, g=g,
                                                    reverse=True))


class VITS(model.VITS):
    """The frozen VITS with the UNet duration predictor and
    ``phoneme_vae``."""

    def __init__(self, n_vocab: int, c):
        if not c.use_phoneme_vae or c.duration_predictor != "unet":
            raise ValueError("this reference holds bv2: the UNet duration "
                             "predictor and the phoneme VAE")
        super().__init__(n_vocab,
                         dataclasses.replace(c, use_phoneme_vae=False))
        self.cfg = c
        self.phoneme_vae = PhonemeVAE(c.inter_channels, c.hidden_channels,
                                      c.n_flow_layer, c.gin_channels)

    def forward(self, x, x_lengths, y, y_lengths, tone, language, *,
                generator, mas_noise_scale: float, mas_std: torch.Tensor,
                n_text: torch.Tensor, n_frames: torch.Tensor,
                path: Optional[torch.Tensor] = None):
        """The frozen forward with the prosody added to z before
        ``o_proj``; its second loss term is the frame KL plus the phoneme
        KL."""
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
        logw_ = torch.log(attn.sum(dim=1) + 1e-6)[..., None] * x_mask
        logw = self.dp(x_h, x_lengths, y, y_lengths)
        l_length = torch.sum(torch.sum((logw - logw_) ** 2, dim=(1, 2))
                             / n_text)
        m_p_e = torch.matmul(attn, m_p.float())
        logs_p_e = torch.matmul(attn, logs_p.float())
        kl = logs_p_e - logs_q.float() - 0.5
        kl = kl + 0.5 * (z_p.float() - m_p_e) ** 2 * torch.exp(-2.0 * logs_p_e)
        loss_kl = torch.sum(kl * y_mask.float()) / n_frames
        prosody, loss_kl_ph = self.phoneme_vae(z, attn, x_h, x_mask, g,
                                               generator=generator,
                                               n_text=n_text)
        content = self.o_proj(z + prosody, y_lengths, g=g,
                              generator=generator)
        return content, (l_length, loss_kl + loss_kl_ph), attn

    def infer(self, x, x_lengths, y, y_lengths, tone, language, *,
              noise_scale: float, length_scale: float, max_len: int,
              generator, w_ceil: Optional[torch.Tensor] = None,
              out_lengths: Optional[torch.Tensor] = None):
        """The frozen inference with the prosody added after the spec
        flow; the VAE's noise is drawn after the prior's."""
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g)
        logw = self.dp(x_h, x_lengths, y, y_lengths)
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
        z_p = z_p + self.phoneme_vae.infer(attn, x_h, x_mask, g,
                                           noise_scale=noise_scale,
                                           generator=generator)
        return self.o_proj(z_p, out_lengths, g=g), out_lengths, logw


class DiffVits(model.DiffVits):
    """The frozen model with bv2's VITS."""

    def __init__(self, cfg, n_vocab: int):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.vits = VITS(n_vocab, cfg.vits)
        self.diff_model = model.DiffusionEncoder(cfg.diffusion_encoder,
                                                 cfg.vits.inter_channels)
