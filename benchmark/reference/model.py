"""The model of the reference: the VITS prior and the diffusion denoiser,
their training loss, and sampling with 30-step UniPC.

Copied from the port's plain route for the two duration predictors the
benchmark's configurations use (the UNet predictor and the stochastic
one) and the residual-coupling flow. Two departures serve the benchmark's
comparison and change no result:

* ``loss`` takes the whole batch's normalisers (text tokens, frames, rows
  and the MAS noise's standard deviation), so that a batch can be run a
  block of rows at a time inside ``draws.rows`` and the blocks' losses
  add up to the whole batch's, and an alignment to use in place of its
  own MAS when the comparison follows the program's (see
  ``benchmark.check``);
* ``synthesize`` takes the per-token frame counts ``w_ceil`` and their
  totals when the comparison follows the program's alignment (see
  ``benchmark.check``), and returns the log durations it computed itself
  beside the mel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import draws
from benchmark.reference.config import Config
from benchmark.reference.layers import (
    WN, ConvFlow, ConvLayer, DDSConv, ElementwiseAffine, EncSALayer, Encoder,
    Flip, Log, ResidualCouplingLayer, TextTimeEmbedding, generate_path,
    maximum_path, sequence_mask)
from benchmark.reference.sampler import (
    NoiseScheduleVP, linear_beta_schedule, sample_unipc, time_steps_uniform)
from benchmark.reference.unet import UNet1DConditionModel


def _mask(lengths, t, dtype):
    return sequence_mask(lengths, t).to(dtype)[..., None]


class TextEncoder(nn.Module):
    def __init__(self, n_vocab, out_channels, hidden_channels,
                 filter_channels, n_heads, n_layers, kernel_size, p_dropout,
                 gin_channels, num_tones=11, num_languages=3):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.emb = nn.Embedding(n_vocab, h)
        self.tone_emb = nn.Embedding(num_tones, h)
        self.language_emb = nn.Embedding(num_languages, h)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers,
                               kernel_size, p_dropout,
                               gin_channels=gin_channels)
        self.proj = nn.Linear(h, 2 * out_channels)

    def forward(self, x, x_lengths, tone, language, g=None, *,
                generator=None):
        xh = (self.emb(x) + self.tone_emb(tone) + self.language_emb(language)
              ) * math.sqrt(self.hidden_channels)
        x_mask = _mask(x_lengths, xh.shape[1], xh.dtype)
        xh = self.encoder(xh * x_mask, x_mask, g=g, generator=generator)
        m, logs = (self.proj(xh) * x_mask).chunk(2, dim=-1)
        return xh, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    def __init__(self, in_channels, out_channels, hidden_channels,
                 kernel_size, dilation_rate, n_layers, gin_channels):
        super().__init__()
        self.pre = nn.Linear(in_channels, hidden_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = nn.Linear(hidden_channels, 2 * out_channels)

    def forward(self, x, x_lengths, g=None, *, generator=None):
        x_mask = _mask(x_lengths, x.shape[1], x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask, g=g)
        m, logs = (self.proj(h) * x_mask).chunk(2, dim=-1)
        noise = draws.randn(m.shape, generator, m.device).to(m.dtype)
        return (m + noise * torch.exp(logs)) * x_mask, m, logs, x_mask


class PromptEncoder(nn.Module):
    def __init__(self, in_channels, hidden_channels, out_channels, n_layers,
                 p_dropout, gin_channels=None):
        super().__init__()
        self.n_layers = n_layers
        self.g_proj = (nn.Linear(gin_channels, in_channels)
                       if gin_channels is not None else None)
        self.pre = ConvLayer(in_channels, hidden_channels, 1)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncSALayer(
                hidden_channels, 8, 9, p_dropout=p_dropout))
        self.out_proj = ConvLayer(hidden_channels, out_channels, 1)
        self.layer_norm = nn.LayerNorm(out_channels, eps=1e-5)

    def forward(self, x, lengths, g=None, *, generator=None):
        if g is not None and self.g_proj is not None:
            x = x + self.g_proj(g)
        keep = _mask(lengths, x.shape[1], x.dtype)
        x = self.pre(x, keep) * keep
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, keep, generator=generator)
        x = self.out_proj(x) * keep
        return self.layer_norm(x) * keep


class DurationPredictorUNet(nn.Module):
    """A UNet over the text, cross-attending to the mel prompt."""

    def __init__(self, in_channels, hidden_channels, prompt_channels):
        super().__init__()
        h = hidden_channels
        self.prompt_proj = nn.Linear(prompt_channels, h)
        self.pre = nn.Linear(in_channels, h)
        self.enc = UNet1DConditionModel(
            h, 1, block_out_channels=(h // 4, h // 4, h // 2, h // 2),
            norm_num_groups=8, cross_attention_dim=h, attention_head_dim=8)

    def forward(self, x, x_lengths, prompt, prompt_lengths):
        x, prompt = x.detach(), self.prompt_proj(prompt.detach())
        x_mask = _mask(x_lengths, x.shape[1], x.dtype)
        prompt_keep = sequence_mask(prompt_lengths, prompt.shape[1])
        prompt = prompt * prompt_keep.to(prompt.dtype)[..., None]
        out = self.enc(self.pre(x) * x_mask, torch.ones((), dtype=torch.int32),
                       prompt, prompt_keep)
        return out * x_mask


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration predictor: the forward gives the NLL [B] of w,
    the reverse samples log durations [B, T, 1] (three ConvFlow reverses:
    ``flow_0`` is dropped from the reversed order)."""

    def __init__(self, in_channels, kernel_size, p_dropout, n_flows,
                 gin_channels):
        super().__init__()
        fc = in_channels
        self.n_flows = n_flows
        self.pre = nn.Linear(in_channels, fc)
        self.cond = nn.Linear(gin_channels, fc)
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

    def _flows(self, prefix: str, n: int):
        steps = [getattr(self, f"{prefix}_pre")]
        for i in range(n):
            steps += [getattr(self, f"{prefix}_{i}"),
                      getattr(self, f"{prefix}_flip_{i}")]
        return steps

    def forward(self, x, x_mask, w=None, g=None, reverse=False,
                noise_scale=1.0, *, generator=None):
        x = self.pre(x.detach()) + self.cond(g.detach())
        x = self.convs(x, x_mask, generator=generator)
        x = self.proj(x) * x_mask
        shape = (x.shape[0], x.shape[1], 2)
        if reverse:
            steps = self._flows("flow", self.n_flows)[::-1]
            steps = steps[:-2] + steps[-1:]
            z = draws.normal_like(shape, x, generator) * noise_scale
            for step in steps:
                z = step(z, x_mask, g=x, reverse=True)
            return z[..., :1]
        h_w = self.post_convs(self.post_pre(w), x_mask, generator=generator)
        h_w = self.post_proj(h_w) * x_mask
        e_q = draws.normal_like(shape, w, generator) * x_mask
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


class ResidualCouplingBlock(nn.Module):
    def __init__(self, channels, hidden_channels, kernel_size, dilation_rate,
                 n_layers, n_flows, gin_channels):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels=gin_channels))
            self.add_module(f"flip_{i}", Flip())

    def forward(self, x, x_mask, g=None, reverse=False):
        steps = []
        for i in range(self.n_flows):
            steps += [getattr(self, f"flow_{i}"), getattr(self, f"flip_{i}")]
        if not reverse:
            for step in steps:
                x, _ = step(x, x_mask, g=g) if isinstance(
                    step, ResidualCouplingLayer) else step(x, x_mask)
            return x
        for step in reversed(steps):
            x = step(x, x_mask, g=g, reverse=True)
        return x


class VITS(nn.Module):
    def __init__(self, n_vocab: int, c):
        super().__init__()
        if c.duration_predictor not in ("unet", "sdp") or c.use_phoneme_vae \
                or (c.use_flow and c.use_transformer_flow):
            raise ValueError("the reference holds the UNet and stochastic "
                             "duration predictors and the residual flow")
        self.cfg = c
        self.enc_p = TextEncoder(n_vocab, c.inter_channels, c.hidden_channels,
                                 c.filter_channels, c.n_heads, c.n_layers,
                                 c.kernel_size, c.p_dropout, c.gin_channels)
        self.enc_q = PosteriorEncoder(
            c.posterior_in_channels, c.inter_channels, c.hidden_channels,
            c.posterior_kernel_size, c.posterior_dilation_rate,
            c.posterior_n_layers, c.gin_channels)
        self.ref_enc = TextTimeEmbedding(c.posterior_in_channels,
                                         c.gin_channels, num_heads=1)
        if c.duration_predictor == "unet":
            self.dp = DurationPredictorUNet(c.hidden_channels, 256,
                                            c.posterior_in_channels)
        else:
            self.dp = StochasticDurationPredictor(c.hidden_channels, 3, 0.5,
                                                  4, c.gin_channels)
        self.flow = (ResidualCouplingBlock(
            c.inter_channels, c.hidden_channels, 5, 1, 4, c.n_flow_layer,
            c.gin_channels) if c.use_flow else None)
        self.o_proj = PromptEncoder(c.inter_channels, c.hidden_channels,
                                    c.inter_channels, 6, 0.2,
                                    gin_channels=c.gin_channels)

    def neg_cent(self, x, x_lengths, y, y_lengths, tone, language, *,
                 generator):
        """The training forward up to MAS: (scores [B, Ty, Tx], the
        pieces the rest of the forward needs)."""
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g, generator=generator)
        z, m_q, logs_q, y_mask = self.enc_q(y, y_lengths, g=g,
                                            generator=generator)
        z_p = z if self.flow is None else self.flow(z, y_mask, g=g)
        with torch.no_grad():
            zf, m_pf, logs_pf = z_p.float(), m_p.float(), logs_p.float()
            s_p_sq_r = torch.exp(-2.0 * logs_pf)
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_pf,
                                  dim=-1)
            neg_cent2 = torch.matmul(-0.5 * zf ** 2, s_p_sq_r.transpose(1, 2))
            neg_cent3 = torch.matmul(zf, (m_pf * s_p_sq_r).transpose(1, 2))
            neg_cent4 = torch.sum(-0.5 * m_pf ** 2 * s_p_sq_r, dim=-1)
            nc = (neg_cent1[:, None, :] + neg_cent2 + neg_cent3
                  + neg_cent4[:, None, :])
        return nc, (g, x_h, m_p, logs_p, x_mask, z, logs_q, y_mask, z_p)

    def forward(self, x, x_lengths, y, y_lengths, tone, language, *,
                generator, mas_noise_scale: float, mas_std: torch.Tensor,
                n_text: torch.Tensor, n_frames: torch.Tensor,
                path: Optional[torch.Tensor] = None):
        """The training forward with the whole batch's normalisers: MAS
        noise scaled by ``mas_std``, the duration loss over ``n_text``
        tokens and the KL over ``n_frames`` frames. ``path`` [B, Ty, Tx]:
        the alignment to use in place of this forward's own MAS (whose
        noise is drawn all the same)."""
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
        if self.cfg.duration_predictor == "sdp":
            nll = self.dp(x_h, x_mask, w=w[..., None], g=g,
                          generator=generator)
            l_length = torch.sum(nll.float()) / n_text
        else:
            logw_ = torch.log(w + 1e-6)[..., None] * x_mask
            logw = self.dp(x_h, x_lengths, y, y_lengths)
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
        """(content [B, max_len, C], out_lengths [B], logw [B, Tx, 1]).
        ``w_ceil`` [B, Tx] and ``out_lengths`` [B]: frame counts to expand
        by and totals to keep in place of the ones worked out here from
        ``logw``."""
        g = self.ref_enc(y)[:, None, :]
        x_h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, tone, language,
                                              g=g)
        if self.cfg.duration_predictor == "sdp":
            logw = self.dp(x_h, x_mask, g=g, reverse=True, noise_scale=0.8,
                           generator=generator)
        else:
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
        return self.o_proj(z_p, out_lengths, g=g), out_lengths, logw


class DiffusionEncoder(nn.Module):
    """Prompt encoder + conditional UNet over [noisy mel, content]."""

    def __init__(self, c, content_channels: int):
        super().__init__()
        self.prompt_encoder = PromptEncoder(
            c.in_channels, c.hidden_channels, c.hidden_channels,
            c.n_prompt_layers, 0.2)
        self.unet = UNet1DConditionModel(
            c.in_channels + content_channels, c.out_channels,
            block_out_channels=c.block_out_channels, norm_num_groups=8,
            cross_attention_dim=c.hidden_channels,
            attention_head_dim=c.n_heads)

    def encode_prompt(self, prompt, prompt_lengths, *, generator=None):
        keep = sequence_mask(prompt_lengths, prompt.shape[1])
        h = self.prompt_encoder(prompt, prompt_lengths, generator=generator)
        return h * keep.to(h.dtype)[..., None], keep

    def denoise(self, x, t, cond, prompt_h, prompt_keep, *, emb=None):
        return self.unet(torch.cat([x, cond.to(x.dtype)], dim=-1), t,
                         prompt_h, prompt_keep, emb=emb)


def _snr_weights(timesteps: int):
    betas = linear_beta_schedule(timesteps)
    ac = np.cumprod(1.0 - betas)
    return np.sqrt(ac), np.sqrt(1 - ac), ac / (1 - ac)


class DiffVits(nn.Module):
    """VITS prior (``vits``) + diffusion decoder (``diff_model``)."""

    def __init__(self, cfg: Config, n_vocab: int):
        super().__init__()
        self.cfg = cfg
        self.vits = VITS(n_vocab, cfg.vits)
        self.diff_model = DiffusionEncoder(cfg.diffusion_encoder,
                                           cfg.vits.inter_channels)

    def loss(self, text, text_lengths, spec, spec_lengths, refer,
             refer_lengths, tone, language, *, generator,
             mas_noise_scale: float, mas_std, n_text, n_frames,
             b_total: int, path: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """This block's share of the whole batch's loss terms: loss = 40
        diff + len + kl, the diffusion term a mean over ``b_total`` rows
        of per-row SNR-weighted means; ``path`` as ``VITS.forward``, and
        the alignment used under ``"path"``."""
        content, (l_length, loss_kl), attn = self.vits(
            text, text_lengths, spec, spec_lengths, tone, language,
            generator=generator, mas_noise_scale=mas_noise_scale,
            mas_std=mas_std, n_text=n_text, n_frames=n_frames, path=path)
        b = spec.shape[0]
        n_steps = self.cfg.train.timesteps
        sa, s1a, snr = (torch.tensor(a, dtype=torch.float32,
                                     device=spec.device)
                        for a in _snr_weights(n_steps))
        t = draws.randint(n_steps, (b,), generator, spec.device)
        x_mask = _mask(spec_lengths, content.shape[1], spec.dtype)
        x_start = spec * x_mask
        noise = draws.randn(x_start.shape, generator, spec.device)
        x = sa[t][:, None, None] * x_start + s1a[t][:, None, None] * (
            noise * x_mask)
        dm = self.diff_model
        prompt_h, keep = dm.encode_prompt(refer, refer_lengths,
                                          generator=generator)
        model_out = dm.denoise(x, t, content, prompt_h, keep)
        mse = (model_out.float() - x_start.float()) ** 2
        loss_diff = (mse.reshape(b, -1).mean(dim=-1) * snr[t]).sum() / b_total
        loss = 40.0 * loss_diff + l_length + loss_kl
        return {"loss/all": loss, "loss/diff": loss_diff,
                "loss/len": l_length, "loss/kl": loss_kl, "path": attn}


@torch.no_grad()
def synthesize(model: DiffVits, text, text_lengths, refer, refer_lengths,
               tone, language, *, generator: torch.Generator, max_len: int,
               noise_scale: float, length_scale: float, steps: int = 30,
               w_ceil: Optional[torch.Tensor] = None,
               out_lengths: Optional[torch.Tensor] = None):
    """text [B, Tx] + prompt mel [B, S, 100] -> (mel [B, max_len, 100],
    out_lengths [B], logw [B, Tx, 1]) with 30-step UniPC (bh2, order 2,
    data prediction, time-uniform grid). ``generator`` draws the
    stochastic durations, the prior noise and x_T, in that order."""
    dev = next(model.parameters()).device
    content, out_lengths, logw = model.vits.infer(
        text, text_lengths, refer, refer_lengths, tone, language,
        noise_scale=noise_scale, length_scale=length_scale, max_len=max_len,
        generator=generator, w_ceil=w_ceil, out_lengths=out_lengths)
    ns = NoiseScheduleVP(linear_beta_schedule(model.cfg.train.timesteps))
    b, t_y = content.shape[0], content.shape[1]
    c_mel = model.cfg.diffusion_encoder.out_channels
    x = draws.randn((b, t_y, c_mel), generator, generator.device).to(dev)
    dm = model.diff_model
    prompt_h, prompt_keep = dm.encode_prompt(refer, refer_lengths)
    td_grid = time_steps_uniform(ns, steps) * ns.total_N - 1.0
    emb_all = (dm.unet.embed_time(td_grid.to(dev))[:, None, :]
               + dm.unet.add_embedding(prompt_h)[None, :, :])

    def x0_fn(x, t_discrete, step_index):
        return dm.denoise(x, t_discrete, content, prompt_h, prompt_keep,
                          emb=emb_all[step_index])

    return sample_unipc(x0_fn, ns, x, steps=steps), out_lengths, logw
