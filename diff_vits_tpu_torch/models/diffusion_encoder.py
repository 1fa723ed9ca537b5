"""Conditional diffusion denoiser: prompt encoder + UNet1D.

Port of ``diff_vits_tpu/models/diffusion_encoder.py``: the prompt mel is
encoded once per utterance into cross-attention keys; each denoiser call
runs the UNet on [noisy mel, content] with those keys. ``forward`` is the
training call: both, with the UNet embedding its own timesteps. With
``moe_experts`` > 0 every transformer block of the UNet has the MoE
feed-forward (``parallel.moe``), as in JAX (diffusion_encoder.py:37-38).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diff_vits_tpu_torch import ops
from diff_vits_tpu_torch.core import masking, trace
from diff_vits_tpu_torch.core.config import DiffusionEncoderConfig
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.models.encoders import PromptEncoder
from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel


class DiffusionEncoder(nn.Module):

    def __init__(self, cfg: DiffusionEncoderConfig, *,
                 content_channels: Optional[int] = None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        """``content_channels``: the width of ``cond`` (the VITS content,
        ``vits.inter_channels``), which flax's ``conv_in`` infers from the
        data; ``hidden_channels`` unless given."""
        super().__init__()
        device = resolve_device(device)
        c = cfg
        content = c.hidden_channels if content_channels is None \
            else content_channels
        kw = dict(device=device, dtype=dtype)
        self.prompt_encoder = PromptEncoder(
            c.in_channels, c.hidden_channels, c.hidden_channels,
            c.n_prompt_layers, **kw)
        self.unet = UNet1DConditionModel(
            in_channels=c.in_channels + content,
            out_channels=c.out_channels,
            block_out_channels=c.block_out_channels, norm_num_groups=8,
            cross_attention_dim=c.hidden_channels,
            attention_head_dim=c.n_heads, addition_embed_type="text",
            moe_experts=c.moe_experts, moe_top_k=c.moe_top_k, **kw)
        self.to(**kw)

    def forward(self, x, t, cond, prompt, cond_lengths, prompt_lengths, *,
                generator: Optional[torch.Generator] = None):
        """x [B, T, C_mel] noisy mel, t [B] steps, cond [B, T, C] content,
        prompt [B, S, C_mel] -> x0 prediction [B, T, C_mel]
        (diffusion_encoder.py:72-86; ``cond_lengths`` unused there too)."""
        prompt_h, prompt_keep = self.encode_prompt(prompt, prompt_lengths,
                                                   generator=generator)
        return self.denoise(x, t, cond, prompt_h, prompt_keep)

    def encode_prompt(self, prompt, prompt_lengths, *,
                      generator: Optional[torch.Generator] = None):
        """Prompt mel -> cross-attention keys [B, S, C] and keep mask."""
        prompt = prompt.to(self.unet.conv_in.weight.dtype)
        prompt_keep = masking.sequence_mask(prompt_lengths, prompt.shape[1])
        prompt_h = self.prompt_encoder(prompt, prompt_lengths,
                                       generator=generator)
        prompt_h = prompt_h * prompt_keep.to(prompt_h.dtype)[..., None]
        return prompt_h, prompt_keep

    def denoise(self, x, t, cond, prompt_h, prompt_keep, *, emb=None):
        """One UNet x0 prediction given pre-encoded prompt keys. One
        ``dvt.denoise`` span of the port's tracer (``core.trace``), with
        the change of ``ops.launch_counts()`` over the call."""
        with trace.span("dvt.denoise", delta=ops.launch_counts):
            h = torch.cat([x, cond.to(x.dtype)], dim=-1)
            return self.unet(h, t, prompt_h,
                             encoder_attention_mask=prompt_keep, emb=emb)

    def embed_time(self, timesteps):
        """Timestep-MLP embeddings [N, 4*ch0] for the solver's times."""
        return self.unet(None, timesteps, None, embedding_request="time")

    def embed_text(self, prompt_h):
        """Pooled 'text' additive embedding [B, 4*ch0]."""
        return self.unet(None, None, prompt_h, embedding_request="text")
