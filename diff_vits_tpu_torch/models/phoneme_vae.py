"""Phoneme-level prosody VAE (the bv2 variant), channel-last.

Port of ``diff_vits_tpu/models/phoneme_vae.py``: the frame latents are
mean-pooled into phoneme segments along the hard MAS alignment
``attn [B, Ty, Tx]`` and the phoneme features repeated back per frame,
both as batched matmuls (pooled = attn^T z / max(counts, 1), expanded =
attn ph). Training returns the prosody to add to the frame latent and the
phoneme KL; inference samples the phoneme prior, runs the flow in reverse
and expands to frames. Noise comes from the caller's ``torch.Generator``
or is injected (``noise``); the submodules carry the flax names.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.models.duration import draw_normal
from diff_vits_tpu_torch.models.flow import ResidualCouplingBlock
from diff_vits_tpu_torch.nn.fairseq import EncSALayer


def group_by_alignment(z: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Mean-pool frame features into phoneme segments (phoneme_vae.py:27).
    z [B, Ty, C], attn [B, Ty, Tx] -> [B, Tx, C]."""
    attn = attn.to(z.dtype)
    counts = attn.sum(dim=1)                                # [B, Tx]
    pooled = torch.matmul(attn.transpose(1, 2), z)
    return pooled / torch.clamp(counts, min=1.0)[..., None]


def expand_by_alignment(ph: torch.Tensor, attn: torch.Tensor
                        ) -> torch.Tensor:
    """Repeat phoneme features per frame (phoneme_vae.py:38).
    ph [B, Tx, C], attn [B, Ty, Tx] -> [B, Ty, C]."""
    return torch.matmul(attn.to(ph.dtype), ph)


def _sample(m, logs, x_mask, noise, generator):
    """z = (m + noise * exp(logs)) * mask, the noise injected or drawn from
    ``generator``; z = m * mask with neither."""
    if noise is None and generator is None:
        return m * x_mask
    if noise is None:
        noise = torch.randn(m.shape, generator=generator, device=m.device)
    return (m + noise.to(m.dtype) * torch.exp(logs)) * x_mask


class PhEncoder(nn.Module):
    """Phoneme posterior: Dense -> Dense -> (m, logs) -> z
    (phoneme_vae.py:46)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.proj = nn.Linear(hidden_channels, 2 * out_channels)

    def forward(self, x, x_mask, *, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.pre(x) * x_mask
        m, logs = (self.proj(h) * x_mask).chunk(2, dim=-1)
        return _sample(m, logs, x_mask, noise, generator), m, logs


class PhPriorEncoder(nn.Module):
    """Phoneme prior over the text hiddens: Dense, ``n_layers`` EncSALayers
    (8 heads, FFN kernel 9, dropout ``p_dropout``), Dense -> (m, logs)
    (phoneme_vae.py:67). Its layers take K8 where ``uses_flash`` says."""

    def __init__(self, hidden_channels: int, out_channels: int,
                 n_layers: int = 4, p_dropout: float = 0.2):
        super().__init__()
        self.n_layers = n_layers
        self.pre = nn.Linear(hidden_channels, hidden_channels)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncSALayer(
                hidden_channels, num_heads=8, kernel_size=9,
                p_dropout=p_dropout))
        self.proj = nn.Linear(hidden_channels, 2 * out_channels)

    def forward(self, x, x_mask, *,
                generator: Optional[torch.Generator] = None):
        h = self.pre(x) * x_mask
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, x_mask, generator=generator)
        m, logs = (self.proj(h) * x_mask).chunk(2, dim=-1)
        return m * x_mask, m, logs


class PhonemeVAE(nn.Module):
    """Posterior (``ph_encoder_q``), flow (``phoneme_flow``) and prior
    (``ph_enc_p``) of the phoneme prosody (phoneme_vae.py:100)."""

    def __init__(self, inter_channels: int, hidden_channels: int,
                 n_flow_layer: int = 4, gin_channels: int = 0, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.ph_encoder_q = PhEncoder(inter_channels, inter_channels,
                                      inter_channels)
        self.phoneme_flow = ResidualCouplingBlock(
            inter_channels, hidden_channels, 5, 1, n_flow_layer,
            gin_channels=gin_channels, **kw)
        self.ph_enc_p = PhPriorEncoder(hidden_channels, inter_channels)
        self.to(**kw)

    def forward(self, z, attn, x_hidden, x_mask, g=None, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rank_mean: Optional[masking.Reduce] = None):
        """Training path (phoneme_vae.py:122): z [B, Ty, C] the frame
        latent, attn [B, Ty, Tx] the MAS path, x_hidden [B, Tx, H] the text
        hiddens, x_mask [B, Tx, 1]. The posterior draw is ``noise``
        [B, Tx, C] or from ``generator``; with neither it is the mean.
        ``generator`` also draws the dropout masks. ``rank_mean``
        is ``masking.kl_loss``'s. Returns (prosody [B, Ty, C],
        loss_kl_ph)."""
        z_ph = group_by_alignment(z, attn)
        z_q_ph, _, logs_q_ph = self.ph_encoder_q(z_ph, x_mask, noise=noise,
                                                 generator=generator)
        z_p_ph = self.phoneme_flow(z_q_ph, x_mask, g=g, generator=generator)
        _, m_p_ph, logs_p_ph = self.ph_enc_p(x_hidden, x_mask,
                                             generator=generator)
        loss_kl_ph = masking.kl_loss(z_p_ph, logs_q_ph, m_p_ph, logs_p_ph,
                                     x_mask, rank_mean)
        return expand_by_alignment(z_q_ph, attn), loss_kl_ph

    def infer(self, attn, x_hidden, x_mask, g=None, *,
              noise_scale: float = 0.667,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Inference path (phoneme_vae.py:138): the prior sample
        m + noise * exp(logs) * noise_scale (``noise`` [B, Tx, C] injected,
        else drawn from ``generator``, not drawn at noise_scale 0), the
        flow reversed, expanded to frames [B, Ty, C]."""
        _, m_p_ph, logs_p_ph = self.ph_enc_p(x_hidden, x_mask)
        ph_p = m_p_ph
        if noise is not None or noise_scale != 0.0:
            if noise is None:
                noise = draw_normal(m_p_ph.shape, m_p_ph, generator)
            ph_p = m_p_ph + noise.to(m_p_ph) * torch.exp(logs_p_ph) \
                * noise_scale
        z_q_ph = self.phoneme_flow(ph_p, x_mask, g=g, reverse=True)
        return expand_by_alignment(z_q_ph, attn)
