"""Vocos mel -> waveform vocoder: a ConvNeXt backbone and an ISTFT head.

Port of ``diff_vits_tpu/models/vocoder.py``, the architecture of the
published ``charactr/vocos-mel-24khz``: 100 mel bins -> embedding conv
(k7) -> LayerNorm -> 8 ConvNeXt blocks (dim 512, intermediate 1536,
layer scale 1/8) -> LayerNorm -> Linear(512, n_fft + 2) -> magnitude
clip(exp(.), max=1e2) and phase -> ISTFT (n_fft 1024, hop 256, center).

The submodules carry the flax names (``embed``, ``norm``,
``convnext_{i}.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``final_norm``,
``out``), so ``utils.convert.convert_tree`` of the JAX parameters loads
here; ``convert_torch_vocos`` renames the published torch state dict.
No TPU kernel stands behind this module: the products are ``nn.Linear``
and ``nn.Conv1d``, the inverse FFT ``torch.fft.irfft``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.ops.stft import hann_window
from diff_vits_tpu_torch.train.checkpoint import load_checkpoint
from diff_vits_tpu_torch.utils.convert import convert_tree
from diff_vits_tpu_torch.utils.init import init_random


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv -> LayerNorm -> pwconv1 -> exact GELU -> pwconv2,
    scaled by ``gamma`` and added to the input; x [B, T, C]."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init: float = 1.0 / 8, *,
                 device: DeviceLike = None):
        super().__init__()
        kw = dict(device=device)
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.norm = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.pwconv1 = nn.Linear(dim, intermediate_dim, **kw)
        self.pwconv2 = nn.Linear(intermediate_dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init,
                                             **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        return x + self.gamma * h


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 1024,
          hop_length: int = 256,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with a Hann window and window-envelope normalisation,
    as torch.istft(center=True). real / imag [B, frames, n_fft // 2 + 1];
    the imaginary parts of DC and Nyquist drop out, as in the JAX
    package's cos / sin synthesis. Returns [B, (frames - 1) * hop]
    (or ``length``) samples."""
    window = torch.from_numpy(hann_window(n_fft)).to(real.device)
    # a real signal's DC and Nyquist bins are real: drop their imaginary
    # parts here, as the cos / sin synthesis does, since a C2R FFT may not
    # (cuFFT's does not ignore them)
    keep = torch.ones(real.shape[-1], device=real.device)
    keep[0] = 0
    if n_fft % 2 == 0:
        keep[-1] = 0
    frames = torch.fft.irfft(torch.complex(real, imag * keep), n=n_fft,
                             dim=-1)
    frames = frames * window                       # [B, F, n_fft]
    b, n_frames, _ = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols):                         # [B, n_fft, F]
        return F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft),
                      stride=(1, hop_length))[:, 0, 0]

    audio = overlap_add(frames.transpose(1, 2))
    env = overlap_add((window ** 2)[None, :, None].expand(1, n_fft,
                                                         n_frames))
    audio = audio / torch.clamp(env, min=1e-11)
    pad = n_fft // 2
    audio = audio[:, pad:out_len - pad]
    if length is not None:
        audio = audio[:, :length]
    return audio


class Vocos(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, (T - 1) * hop] float32."""

    def __init__(self, n_mels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device)
        self.n_fft, self.hop_length = n_fft, hop_length
        self.num_layers = num_layers
        self.embed = nn.Conv1d(n_mels, dim, 7, padding=3, **kw)
        self.norm = nn.LayerNorm(dim, eps=1e-6, **kw)
        for i in range(num_layers):
            self.add_module(f"convnext_{i}",
                            ConvNeXtBlock(dim, intermediate_dim, **kw))
        self.final_norm = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.out = nn.Linear(dim, n_fft + 2, **kw)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.embed(mel.transpose(1, 2)).transpose(1, 2)
        h = self.norm(h)
        for i in range(self.num_layers):
            h = getattr(self, f"convnext_{i}")(h)
        h = self.out(self.final_norm(h))
        mag, phase = h.float().chunk(2, dim=-1)
        # the clip after the exp, as the published model has it
        mag = torch.clamp(torch.exp(mag), max=1e2)
        return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                     self.n_fft, self.hop_length)


def load_vocoder(cfg, ckpt_path: Optional[str] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> Vocos:
    """A float32 ``Vocos`` in eval mode on ``device`` (the card unless
    given), sized by ``cfg.data`` (mel bins, window, hop).

    ``ckpt_path`` is a torch state dict in the published layout
    (``.bin``, ``.pt`` or ``.pth``, e.g. charactr/vocos-mel-24khz's
    pytorch_model.bin), renamed by :func:`convert_torch_vocos`, or, as in
    the JAX package, any other file is a checkpoint of
    ``train.checkpoint.load_checkpoint`` (the JAX package's msgpack
    ``.ckpt``) whose state is the flax parameters, or holds them under
    ``"params"``, carried over by ``convert_tree``. With no path the
    weights are random, from ``generator`` (a CPU generator; seed 0
    without one): the audio is noise, for pipeline runs only."""
    device = resolve_device(device)
    voc = Vocos(n_mels=cfg.data.n_mel_channels, n_fft=cfg.data.window_size,
                hop_length=cfg.data.hop_length, device="cpu")
    if ckpt_path:
        if str(ckpt_path).endswith((".bin", ".pt", ".pth")):
            state = torch.load(ckpt_path, map_location="cpu",
                               weights_only=True)
            voc.load_state_dict(convert_torch_vocos(state), strict=True)
        else:
            _, saved = load_checkpoint(ckpt_path)
            voc.load_state_dict(convert_tree(saved.get("params", saved)),
                                strict=True)
    else:
        init_random(voc, generator or torch.Generator().manual_seed(0))
    return voc.to(device).eval()


def convert_torch_vocos(
        state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The published torch Vocos (charactr/vocos-mel-24khz) state dict of
    tensors -> this module's state dict (float32, on the CPU). The
    published layout's conv and linear weights are already torch's; only
    the names change. Keys of the feature extractor and the ISTFT head's
    window are not parameters here and are left out."""
    def get(name):
        return state_dict[name].detach().to("cpu", torch.float32)

    def take(dst, src, leaves=("weight", "bias")):
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = get(f"{src}.{leaf}")

    out: Dict[str, torch.Tensor] = {}
    take("embed", "backbone.embed")
    take("norm", "backbone.norm")
    take("final_norm", "backbone.final_layer_norm")
    take("out", "head.out")
    i = 0
    while f"backbone.convnext.{i}.dwconv.weight" in state_dict:
        blk = f"backbone.convnext.{i}"
        for part in ("dwconv", "norm", "pwconv1", "pwconv2"):
            take(f"convnext_{i}.{part}", f"{blk}.{part}")
        out[f"convnext_{i}.gamma"] = get(f"{blk}.gamma")
        i += 1
    return out
