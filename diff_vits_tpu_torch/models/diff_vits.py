"""Zero-shot TTS model (VITS prior + conditional diffusion decoder): its
training loss and its sampling entry point.

Port of ``DiffVits`` and ``synthesize`` of
``diff_vits_tpu/models/diff_vits.py``. Training (``DiffVits.forward``,
diff_vits.py:88-151): the VITS forward gives content and the duration and
KL losses; the target mel is noised to a random step and the UNet predicts
it back (x0 objective, SNR-weighted); loss = 40 diff + len + kl + kl_ph.
Inference: text + prompt mel -> content (VITS.infer) -> a sampler over the
UNet denoiser (30-step UniPC by default; DPM-Solver++, DDIM and DDPM as in
diff_vits.py:224-236) -> mel. The prompt is encoded once; for UniPC and
DPM-Solver++ every step's time + text embedding is computed in one batched
call before the loop (``emb_all``, diff_vits.py:197-222), while DDIM and
DDPM call the UNet on integer steps, which it embeds itself each call.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking, trace
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.diffusion.dpm_solver import (
    sample_dpmpp, time_steps_uniform)
from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP
from diff_vits_tpu_torch.diffusion.schedule import (
    GaussianDiffusion, linear_beta_schedule)
from diff_vits_tpu_torch.diffusion.uni_pc import sample_unipc
from diff_vits_tpu_torch.models.diffusion_encoder import DiffusionEncoder
from diff_vits_tpu_torch.models.duration import draw_normal
from diff_vits_tpu_torch.models.vits import VITS
from diff_vits_tpu_torch.parallel import activations

SAMPLE_METHODS = ("unipc", "dpmsolver", "ddim", "ddpm")


class DiffVits(nn.Module):
    """VITS prior (``vits``) + diffusion decoder (``diff_model``)."""

    def __init__(self, cfg: Config, n_vocab: int, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vits = VITS(n_vocab, cfg.vits, device=device, dtype=dtype)
        self.diff_model = DiffusionEncoder(
            cfg.diffusion_encoder, content_channels=cfg.vits.inter_channels,
            device=device, dtype=dtype)
        self._gd: Optional[GaussianDiffusion] = None

    def diffusion(self, device: torch.device) -> GaussianDiffusion:
        """The DDPM buffers of ``cfg.train.timesteps`` on ``device``."""
        if self._gd is None or self._gd.loss_weight.device != device:
            self._gd = GaussianDiffusion.create(self.cfg.train.timesteps,
                                                device)
        return self._gd

    def forward(self, text, text_lengths, spec, spec_lengths, refer,
                refer_lengths, tone, language, *,
                generator: Optional[torch.Generator] = None,
                mas_noise_scale: float = 0.0,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                dur_noise: Optional[torch.Tensor] = None,
                rank_mean: Optional[masking.Reduce] = None
                ) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor],
                                               torch.Tensor, torch.Tensor]]:
        """Training loss. text/tone/language [B, Tx]; spec [B, Ty, 100] the
        target mel; refer [B, S, 100] the prompt (the caller picks refer1 or
        refer2). ``generator`` (on the model's device) draws the posterior
        and MAS noise, t, the diffusion noise and every dropout mask. With
        ``generator=None``, ``t`` [B] and ``noise`` [B, Ty, 100] must be
        given and the posterior and MAS noise are zero: the parity mode,
        where ``dur_noise`` [B, Tx, 2] injects the stochastic duration
        predictor's posterior draw (``VITS.forward``).
        ``rank_mean`` (data parallelism: a statistic -> its mean over the
        ranks) is ``VITS.forward``'s; ``loss_diff``, a mean of per-item
        means, needs none.
        Inside a ``parallel.activations`` sequence-parallel scope the UNet
        runs on this rank's frames (the noise is drawn whole, as everything
        outside the UNet runs whole on every ``seq`` rank, and the UNet
        cuts its input), and ``loss`` is this rank's share of one process's
        loss: its frames' diffusion term over the whole frame count, plus
        the terms every ``seq`` rank computes alike divided by their
        number, so that the gradients summed over ``seq``
        (``Plan.reduce_grads``) are one process's; ``model_out`` and
        ``target`` are this rank's frames, the metrics the whole loss's.
        Returns (loss, (metrics, model_out, target))."""
        if generator is None and (t is None or noise is None):
            raise ValueError("generator=None needs injected t and noise")
        gd = self.diffusion(spec.device)
        content, lengths, (l_length, loss_kl, loss_kl_ph) = self.vits(
            text, text_lengths, spec, spec_lengths, tone, language,
            mas_noise_scale=mas_noise_scale, dur_noise=dur_noise,
            generator=generator, rank_mean=rank_mean)

        b = spec.shape[0]
        if t is None:
            t = torch.randint(0, gd.num_timesteps, (b,), generator=generator,
                              device=spec.device)
        x_mask = masking.sequence_mask(lengths, content.shape[1]).to(
            spec.dtype)[..., None]
        x_start = spec * x_mask
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=spec.device)
        x = gd.q_sample(x_start, t, noise * x_mask)

        model_out = self.diff_model(x, t, content, refer, lengths,
                                    refer_lengths, generator=generator)
        target = x_start
        seq = activations.shard(
            spec.shape[1], len(self.cfg.diffusion_encoder.block_out_channels))
        if seq is not None:     # the UNet gave this rank's frames
            target = seq.cut(target)
        mse = (model_out.float() - target.float()) ** 2
        if seq is None:
            loss_diff = (mse.reshape(b, -1).mean(dim=-1)
                         * gd.loss_weight[t]).mean()
            loss = 40.0 * loss_diff + l_length + loss_kl + loss_kl_ph
            total = loss
        else:
            # this rank's frames' share of the per-item means; the terms
            # every seq rank computes alike count 1 / n_seq here
            whole = seq.length * mse.shape[-1]
            part = (mse.reshape(b, -1).sum(dim=-1) / whole
                    * gd.loss_weight[t]).mean()
            rest = l_length + loss_kl + loss_kl_ph
            loss = 40.0 * part + rest / seq.group.size
            loss_diff = seq.group.all_reduce(part)
            total = 40.0 * loss_diff + rest
        metrics = {"loss/diff": loss_diff, "loss/len": l_length,
                   "loss/kl": loss_kl, "loss/kl_ph": loss_kl_ph,
                   "loss/all": total}
        return loss, (metrics, model_out, target)


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """``model`` in eval mode for the block, its own mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


@torch.inference_mode()
def synthesize(model: DiffVits, text, text_lengths, refer, refer_lengths,
               tone, language, *, generator: Optional[torch.Generator] = None,
               sampling_steps: int = 30, sample_method: str = "unipc",
               max_len: Optional[int] = None, noise_scale: float = 0.667,
               length_scale: float = 1.0,
               init_noise: Optional[torch.Tensor] = None,
               dur_noise: Optional[torch.Tensor] = None,
               device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """text [B, Tx] + prompt mel [B, S, 100] -> (mel [B, Ty, 100] float32,
    out_lengths [B]). ``sample_method`` is one of SAMPLE_METHODS (``ddpm``
    takes ``cfg.train.timesteps`` steps whatever ``sampling_steps``).
    ``init_noise`` injects x_T and ``dur_noise`` [B, Tx, 2] the stochastic
    duration predictor's standard normal draw; ``generator`` draws the
    duration, prior, initial and DDPM step noise otherwise. Runs on
    ``device`` (the card unless given), which must hold the model, in eval
    mode whatever the model's mode (no dropout, the kernel routes), as JAX
    samples deterministically; the model's mode is restored after. One
    ``dvt.synthesize`` span of the port's tracer (``core.trace``)."""
    if sample_method not in SAMPLE_METHODS:
        raise ValueError(f"unknown sample_method {sample_method}")
    device = resolve_device(device)
    if _model_device(model).type != device.type:
        raise ValueError(f"model is on {_model_device(model)}, "
                         f"synthesize asked for {device}")

    def dev(t):
        return torch.as_tensor(t).to(_model_device(model))

    text, text_lengths, refer, refer_lengths, tone, language = map(
        dev, (text, text_lengths, refer, refer_lengths, tone, language))
    with trace.span("dvt.synthesize", batch=text.shape[0],
                    text_bucket=text.shape[1], mel_bucket=max_len), \
            eval_mode(model):
        content, out_lengths = model.vits.infer(
            text, text_lengths, refer, refer_lengths, tone, language,
            noise_scale=noise_scale, length_scale=length_scale, max_len=max_len,
            dur_noise=None if dur_noise is None else dev(dur_noise),
            generator=generator)

        ns = NoiseScheduleVP(linear_beta_schedule(model.cfg.train.timesteps))
        b, t_y = content.shape[0], content.shape[1]
        c_mel = model.cfg.diffusion_encoder.out_channels
        if init_noise is not None:
            x = dev(init_noise).float()
        else:
            x = draw_normal((b, t_y, c_mel), _model_device(model), generator)

        dm = model.diff_model
        prompt_h, prompt_keep = dm.encode_prompt(refer, refer_lengths)
        if sample_method in ("ddim", "ddpm"):
            def x0_step(x, t):
                return dm.denoise(x, t, content, prompt_h, prompt_keep)
            gd = model.diffusion(x.device)
            if sample_method == "ddim":
                return gd.ddim_sample(x0_step, x, sampling_steps,
                                      generator=generator), out_lengths
            return gd.p_sample_loop(x0_step, x,
                                    generator=generator), out_lengths

        td_grid = time_steps_uniform(ns, sampling_steps) * ns.total_N - 1.0
        time_embs = dm.embed_time(dev(td_grid))
        aug = dm.embed_text(prompt_h)
        emb_all = time_embs[:, None, :].float() + aug[None, :, :].float()

        def x0_fn(x, t_discrete, step_index):
            return dm.denoise(x, t_discrete, content, prompt_h, prompt_keep,
                              emb=emb_all[step_index])

        sample = sample_unipc if sample_method == "unipc" else sample_dpmpp
        return sample(x0_fn, ns, x, steps=sampling_steps), out_lengths
