"""VITS prior, inference path: text -> durations -> expanded content.

Port of ``VITS._predict_durations``, ``predict_lengths`` and ``infer`` of
``diff_vits_tpu/models/vits.py`` for the model3 configuration (UNet
duration predictor, no flow, no phoneme VAE). The posterior encoder
``enc_q`` serves training only and is not part of this module.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking
from diff_vits_tpu_torch.core.config import VitsConfig
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.models.duration import DurationPredictorUNet
from diff_vits_tpu_torch.models.encoders import PromptEncoder, TextEncoder
from diff_vits_tpu_torch.nn.embeddings import TextTimeEmbedding


def check_supported(cfg: VitsConfig) -> None:
    """The port runs the model3 prior; the variants are later slices."""
    if cfg.duration_predictor != "unet" or cfg.use_flow \
            or cfg.use_phoneme_vae:
        raise NotImplementedError(
            "the port supports duration_predictor='unet' without flow or "
            "phoneme VAE (model3); got duration_predictor="
            f"{cfg.duration_predictor!r}, use_flow={cfg.use_flow}, "
            f"use_phoneme_vae={cfg.use_phoneme_vae}")


class VITS(nn.Module):
    """Zero-shot VITS prior (channel-last)."""

    def __init__(self, n_vocab: int, cfg: VitsConfig, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        c = cfg
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.enc_p = TextEncoder(n_vocab, c.inter_channels,
                                 c.hidden_channels, c.filter_channels,
                                 c.n_heads, c.n_layers, c.kernel_size,
                                 gin_channels=c.gin_channels, **kw)
        # speaker conditioning: attention pooling over the prompt mel
        self.ref_enc = TextTimeEmbedding(c.posterior_in_channels,
                                         c.gin_channels, num_heads=1)
        self.dp = DurationPredictorUNet(c.hidden_channels, 256,
                                        c.posterior_in_channels, **kw)
        self.o_proj = PromptEncoder(c.inter_channels, c.hidden_channels,
                                    c.inter_channels, 6,
                                    gin_channels=c.gin_channels, **kw)
        self.to(**kw)

    def _predict_durations(self, x, x_lengths, y, y_lengths, tone, language,
                           length_scale: float = 1.0):
        """Speaker embedding, text encoding, durations, ceil. Returns (g,
        x_h, m_p, logs_p, x_mask, w_ceil, out_lengths) with unclamped
        ``out_lengths`` = max(sum ceil(w), 1)."""
        y = y.to(self.ref_enc.proj.weight.dtype)
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g)
        logw = self.dp(x_h, x_lengths, y, y_lengths)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)[..., 0]
        out_lengths = torch.clamp(w_ceil.sum(dim=-1), min=1.0).to(torch.int32)
        return g, x_h, m_p, logs_p, x_mask, w_ceil, out_lengths

    def predict_lengths(self, x, x_lengths, y, y_lengths, tone, language, *,
                        length_scale: float = 1.0):
        """Predicted mel frame counts [B] (the duration pass only)."""
        return self._predict_durations(x, x_lengths, y, y_lengths, tone,
                                       language, length_scale)[-1]

    def infer(self, x, x_lengths, y, y_lengths, tone, language, *,
              noise_scale: float = 0.667, length_scale: float = 1.0,
              max_len: Optional[int] = None,
              generator: Optional[torch.Generator] = None):
        """Returns (content [B, max_len, C], out_lengths [B]); the prior
        noise comes from ``generator`` (unused when noise_scale is 0)."""
        g, x_h, m_p, logs_p, x_mask, w_ceil, out_lengths = \
            self._predict_durations(x, x_lengths, y, y_lengths, tone,
                                    language, length_scale)
        t_y = max_len if max_len is not None else x.shape[1] * 16
        out_lengths = torch.clamp(out_lengths, max=t_y)
        y_mask = masking.sequence_mask(out_lengths, t_y).to(x_mask.dtype)
        attn = masking.generate_path(
            w_ceil, y_mask[:, :, None] * x_mask[:, None, :, 0])
        m_p_e = torch.matmul(attn, m_p)
        z_p = m_p_e
        if noise_scale != 0.0:
            logs_p_e = torch.matmul(attn, logs_p)
            gen_dev = generator.device if generator is not None else "cpu"
            noise = torch.randn(m_p_e.shape, generator=generator,
                                device=gen_dev, dtype=torch.float32)
            z_p = m_p_e + noise.to(m_p_e) * torch.exp(logs_p_e) * noise_scale
        content = self.o_proj(z_p, out_lengths, g=g)
        return content, out_lengths
