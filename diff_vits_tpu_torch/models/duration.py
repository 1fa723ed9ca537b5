"""UNet-conditioned duration predictor (the model3 predictor).

Port of ``DurationPredictorUNet`` of ``diff_vits_tpu/models/duration.py:22-59``:
text hidden + prompt mel -> UNet1D (timestep fixed to 1) -> log durations.
Its inputs are detached, as the JAX module stops their gradients
(duration.py:41-42): the duration loss trains the predictor alone.
"""
from __future__ import annotations

import torch
from torch import nn

from diff_vits_tpu_torch.core import masking
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel


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
        out = self.enc(x, torch.ones((), dtype=torch.int32), prompt,
                       encoder_attention_mask=prompt_keep)
        return out * x_mask
