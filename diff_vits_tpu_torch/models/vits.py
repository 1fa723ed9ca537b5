"""VITS prior: the training forward (posterior, MAS, duration and KL
losses) and the inference path (text -> durations -> expanded content).

Port of ``VITS.__call__``, ``_predict_durations``, ``predict_lengths`` and
``infer`` of ``diff_vits_tpu/models/vits.py``. Both cover every duration
predictor (``unet``, ``conv``, ``sdp``) with or without the spec flow
(residual or transformer coupling), and the bv2 phoneme prosody VAE
(``use_phoneme_vae``, ``models/phoneme_vae.py``). As in JAX,
``phoneme_vae_warmup_steps`` is read by nothing: the VAE's prosody and KL
count from the first step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking, trace
from diff_vits_tpu_torch.core.config import VitsConfig
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.models.duration import (
    DurationPredictor, DurationPredictorUNet, StochasticDurationPredictor,
    draw_normal)
from diff_vits_tpu_torch.models.encoders import (
    PosteriorEncoder, PromptEncoder, TextEncoder)
from diff_vits_tpu_torch.models.flow import (
    ResidualCouplingBlock, TransformerCouplingBlock)
from diff_vits_tpu_torch.models.phoneme_vae import PhonemeVAE
from diff_vits_tpu_torch.nn.embeddings import TextTimeEmbedding
from diff_vits_tpu_torch.ops.mas import maximum_path


def check_supported(cfg: VitsConfig) -> None:
    """Refuse what the JAX VITS cannot build either: an unknown duration
    predictor. Every other configuration ``core.config`` accepts is
    built."""
    if cfg.duration_predictor not in ("unet", "conv", "sdp"):
        raise ValueError(f"unknown duration_predictor "
                         f"{cfg.duration_predictor!r}")


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
                                 c.p_dropout, gin_channels=c.gin_channels,
                                 **kw)
        self.enc_q = PosteriorEncoder(
            c.posterior_in_channels, c.inter_channels, c.hidden_channels,
            c.posterior_kernel_size, c.posterior_dilation_rate,
            c.posterior_n_layers, gin_channels=c.gin_channels, **kw)
        # speaker conditioning: attention pooling over the prompt mel
        self.ref_enc = TextTimeEmbedding(c.posterior_in_channels,
                                         c.gin_channels, num_heads=1)
        if c.duration_predictor == "unet":
            self.dp = DurationPredictorUNet(c.hidden_channels, 256,
                                            c.posterior_in_channels, **kw)
        elif c.duration_predictor == "sdp":
            self.dp = StochasticDurationPredictor(
                c.hidden_channels, 192, 3, 0.5, 4,
                gin_channels=c.gin_channels, **kw)
        else:
            self.dp = DurationPredictor(c.hidden_channels, 256, 3, 0.5,
                                        gin_channels=c.gin_channels, **kw)
        if c.use_flow and c.use_transformer_flow:
            self.flow = TransformerCouplingBlock(
                c.inter_channels, c.hidden_channels, c.filter_channels,
                c.n_heads, c.n_layers_trans_flow, 5, c.p_dropout,
                c.n_flow_layer, gin_channels=c.gin_channels, **kw)
        elif c.use_flow:
            self.flow = ResidualCouplingBlock(
                c.inter_channels, c.hidden_channels, 5, 1, 4,
                n_flows=c.n_flow_layer, gin_channels=c.gin_channels, **kw)
        else:
            self.flow = None
        self.phoneme_vae = (PhonemeVAE(
            c.inter_channels, c.hidden_channels, n_flow_layer=c.n_flow_layer,
            gin_channels=c.gin_channels, **kw)
            if c.use_phoneme_vae else None)
        self.o_proj = PromptEncoder(c.inter_channels, c.hidden_channels,
                                    c.inter_channels, 6, 0.2,
                                    gin_channels=c.gin_channels, **kw)
        self.to(**kw)

    def forward(self, x, x_lengths, y, y_lengths, tone, language, *,
                mas_noise_scale: float = 0.0,
                dur_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rank_mean: Optional[masking.Reduce] = None):
        """Training forward (vits.py:85-166). x/tone/language [B, Tx]; y
        [B, Ty, 100] the target mel. ``generator`` draws the posterior and
        MAS noise, the stochastic duration predictor's posterior draw and
        every dropout mask; without one the posterior and MAS noise are zero
        (and dropout needs eval mode). The stochastic predictor's draw is
        ``dur_noise`` [B, Tx, 2] (a standard normal draw) when given, else
        from ``generator``, else from a generator seeded 0 (JAX draws from
        PRNGKey(0) there). With the phoneme VAE, ``generator`` also draws
        its posterior noise (zero without one) and the prosody is added to
        z before ``o_proj``. ``rank_mean`` (data parallelism: a
        statistic -> its mean over the ranks) makes the batch statistics
        global: the mask sums that divide l_length, loss_kl and loss_kl_ph
        (``masking.kl_loss``) and the standard deviation that scales the
        MAS noise. Returns (content [B, Ty, C], y_lengths,
        (l_length, loss_kl, loss_kl_ph)), loss_kl_ph 0 without the VAE."""
        kind = self.cfg.duration_predictor
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g, generator=generator)
        z, m_q, logs_q, y_mask = self.enc_q(y, y_lengths, g=g,
                                            generator=generator)
        z_p = z
        if self.flow is not None:
            z_p = self.flow(z, y_mask, g=g, generator=generator)
        attn_mask = y_mask[:, :, 0][:, :, None] * x_mask[:, :, 0][:, None, :]
        attn = self._alignment(z_p, m_p, logs_p, attn_mask, mas_noise_scale,
                               generator, rank_mean)

        w = attn.sum(dim=1)                                     # [B, Tx]
        if kind == "sdp":
            if dur_noise is None and generator is None:
                dur_noise = draw_normal((x.shape[0], x.shape[1], 2), w,
                                        torch.Generator().manual_seed(0))
            nll = self.dp(x_h, x_mask, w=w[..., None], g=g, noise=dur_noise,
                          generator=generator)
            l_length = torch.sum(nll.float()) / masking.denominator(
                torch.sum(x_mask.float()), rank_mean)
        else:
            logw_ = torch.log(w + 1e-6)[..., None] * x_mask
            if kind == "conv":
                logw = self.dp(x_h, x_mask, g=g, generator=generator)
            else:
                logw = self.dp(x_h, x_lengths, y, y_lengths)
            l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) \
                / masking.denominator(torch.sum(x_mask), rank_mean)
            l_length = torch.sum(l_length.float())

        m_p_e = torch.matmul(attn, m_p.float())
        logs_p_e = torch.matmul(attn, logs_p.float())
        loss_kl = masking.kl_loss(z_p, logs_q, m_p_e, logs_p_e, y_mask,
                                  rank_mean)
        loss_kl_ph = torch.zeros((), device=l_length.device)
        if self.phoneme_vae is not None:
            prosody, loss_kl_ph = self.phoneme_vae(
                z, attn, x_h, x_mask, g=g, generator=generator,
                rank_mean=rank_mean)
            z = z + prosody
        content = self.o_proj(z, y_lengths, g=g, generator=generator)
        return content, y_lengths, (l_length, loss_kl, loss_kl_ph)

    @torch.no_grad()
    def _alignment(self, z_p, m_p, logs_p, attn_mask, mas_noise_scale,
                   generator, rank_mean=None):
        """MAS on the negative cross-entropy of z under the prior, in
        float32 with autocast off and no gradient (vits.py:104-124). The
        noise is scaled by the population std of the batch's scores (of the
        global batch under data parallelism, whose ranks hold equal
        shapes)."""
        with torch.autocast(z_p.device.type, enabled=False):
            zf, m_pf, logs_pf = z_p.float(), m_p.float(), logs_p.float()
            s_p_sq_r = torch.exp(-2.0 * logs_pf)                # [B, Tx, D]
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_pf,
                                  dim=-1)                       # [B, Tx]
            neg_cent2 = torch.matmul(-0.5 * zf ** 2, s_p_sq_r.transpose(1, 2))
            neg_cent3 = torch.matmul(zf, (m_pf * s_p_sq_r).transpose(1, 2))
            neg_cent4 = torch.sum(-0.5 * m_pf ** 2 * s_p_sq_r, dim=-1)
            neg_cent = (neg_cent1[:, None, :] + neg_cent2 + neg_cent3
                        + neg_cent4[:, None, :])                # [B, Ty, Tx]
            if generator is not None:
                # jnp.std is the population std
                noise = torch.randn(neg_cent.shape, generator=generator,
                                    device=neg_cent.device)
                if rank_mean is None:
                    std = torch.std(neg_cent, correction=0)
                else:
                    mean = rank_mean(neg_cent.mean())
                    std = torch.sqrt(rank_mean(((neg_cent - mean) ** 2)
                                               .mean()))
                neg_cent = neg_cent + std * noise * mas_noise_scale
            return maximum_path(neg_cent.contiguous(), attn_mask.float())

    def _predict_durations(self, x, x_lengths, y, y_lengths, tone, language,
                           length_scale: float = 1.0,
                           dur_noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
        """Speaker embedding, text encoding, durations, ceil. Returns (g,
        x_h, m_p, logs_p, x_mask, w_ceil, out_lengths) with unclamped
        ``out_lengths`` = max(sum ceil(w), 1). The stochastic predictor
        samples with noise scale 0.8 from ``dur_noise`` [B, Tx, 2] (a
        standard normal draw) or from ``generator``."""
        y = y.to(self.ref_enc.proj.weight.dtype)
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g)
        kind = self.cfg.duration_predictor
        if kind == "sdp":
            logw = self.dp(x_h, x_mask, g=g, reverse=True, noise_scale=0.8,
                           noise=dur_noise, generator=generator)
        elif kind == "conv":
            logw = self.dp(x_h, x_mask, g=g)
        else:
            logw = self.dp(x_h, x_lengths, y, y_lengths)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)[..., 0]
        out_lengths = torch.clamp(w_ceil.sum(dim=-1), min=1.0).to(torch.int32)
        return g, x_h, m_p, logs_p, x_mask, w_ceil, out_lengths

    def predict_lengths(self, x, x_lengths, y, y_lengths, tone, language, *,
                        length_scale: float = 1.0,
                        dur_noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
        """Predicted mel frame counts [B] (the duration pass only)."""
        return self._predict_durations(x, x_lengths, y, y_lengths, tone,
                                       language, length_scale, dur_noise,
                                       generator)[-1]

    def infer(self, x, x_lengths, y, y_lengths, tone, language, *,
              noise_scale: float = 0.667, length_scale: float = 1.0,
              max_len: Optional[int] = None,
              dur_noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Returns (content [B, max_len, C], out_lengths [B]). The
        stochastic duration predictor's noise is ``dur_noise`` or drawn
        from ``generator`` first; the prior noise is drawn from
        ``generator`` next (unused when noise_scale is 0). The spec flow,
        when configured, runs in reverse on the prior sample; the phoneme
        VAE's prosody, when configured, is added after it (its prior noise
        drawn from ``generator`` last, also unused at noise_scale 0). One
        ``dvt.prior`` span of the port's tracer (``core.trace``), with the
        spec flow's ``dvt.flow`` and the VAE's ``dvt.ph_vae`` inside, and
        the VAE's counters ``ph_vae.tokens_real`` (the text's real tokens)
        and ``ph_vae.tokens_held`` (batch x text bucket)."""
        with trace.span("dvt.prior"):
            g, x_h, m_p, logs_p, x_mask, w_ceil, out_lengths = \
                self._predict_durations(x, x_lengths, y, y_lengths, tone,
                                        language, length_scale, dur_noise,
                                        generator)
            t_y = max_len if max_len is not None else x.shape[1] * 16
            out_lengths = torch.clamp(out_lengths, max=t_y)
            y_mask = masking.sequence_mask(out_lengths, t_y).to(x_mask.dtype)
            attn = masking.generate_path(
                w_ceil, y_mask[:, :, None] * x_mask[:, None, :, 0])
            m_p_e = torch.matmul(attn, m_p)
            z_p = m_p_e
            if noise_scale != 0.0:
                logs_p_e = torch.matmul(attn, logs_p)
                noise = draw_normal(m_p_e.shape, m_p_e, generator)
                z_p = m_p_e + noise * torch.exp(logs_p_e) * noise_scale
            if self.flow is not None:
                y_keep = y_mask[..., None]
                with trace.span("dvt.flow", batch=z_p.shape[0], frames=t_y):
                    z_p = self.flow(z_p, y_keep, g=g, reverse=True) * y_keep
            if self.phoneme_vae is not None:
                b, t_x = x_mask.shape[0], x_mask.shape[1]
                with trace.span("dvt.ph_vae", batch=b, text_bucket=t_x):
                    if trace.enabled():
                        # the real tokens are counted on the card
                        trace.count("ph_vae.tokens_real", (x_mask > 0).sum())
                        trace.count("ph_vae.tokens_held", b * t_x)
                    z_p = z_p + self.phoneme_vae.infer(
                        attn, x_h, x_mask, g=g, noise_scale=noise_scale,
                        generator=generator)
            content = self.o_proj(z_p, out_lengths, g=g)
            return content, out_lengths
