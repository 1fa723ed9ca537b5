"""The configuration schema of the reference: the upstream config.json's
sections (train / data / diffusion_encoder / vits) with their defaults,
copied from the port's schema so that a configuration file reads the same
on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    train_batch_size: int = 32
    gradient_accumulate_every: int = 1
    train_lr: float = 1e-4
    train_num_steps: int = 1_000_000
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    save_and_sample_every: int = 1000
    timesteps: int = 1000
    logs_folder: str = "logs/tts"
    seed: int = 1234
    epochs: int = 10000
    use_noise_scaled_mas: bool = True
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6
    num_workers: int = 8
    eps: float = 1e-9
    keep_ckpts: int = 3
    # grad clip schedule: clip 10.0 before `clip_switch_step`, then 1.0
    # (model3.py:1376-1379)
    clip_switch_step: int = 100_000
    clip_before: float = 10.0
    clip_after: float = 1.0
    # Fields the JAX package added for its TPU trainer (no reference
    # equivalent). They are kept so that the same JSON loads to the same
    # dataclass. The port's Trainer reads compute_dtype, use_ema,
    # ema_decay, remat_policy ("none" / "dots" / "full", nn/remat.py) and
    # the mesh (parallel/mesh.py: any of the axes "data", "fsdp", "model",
    # "expert", "seq"; parallel/sharding.py shards the state as JAX's
    # state_sharding_rules do), not dropout_rng_impl (the port draws from
    # a torch.Generator).
    compute_dtype: str = "bfloat16"
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    use_native_loader: bool = True
    use_ema: bool = False
    ema_decay: float = 0.9999
    dropout_rng_impl: str = "rbg"
    vocoder_ckpt: Optional[str] = None
    remat_policy: str = "none"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    training_files: str = "dataset_processed"
    val_files: str = "dataset_processed"
    sampling_rate: int = 24000
    hop_length: int = 256
    window_size: int = 1024
    language: str = "zh"
    add_blank: bool = True
    min_text_len: int = 1
    max_text_len: int = 300
    win_length: int = 2048
    n_mel_channels: int = 100
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    cleaned_text: bool = True
    # Static padded shapes (bucketed padding; the reference pads
    # dynamically per batch, dataset.py:227-287). Serving derives its
    # default mel buckets and prompt frames from max_mel_len.
    max_mel_len: int = 400
    min_mel_len: int = 30


@dataclasses.dataclass(frozen=True)
class DiffusionEncoderConfig:
    """Diffusion_Encoder (model3.py:867-914) hyperparameters."""
    in_channels: int = 100
    out_channels: int = 100
    hidden_channels: int = 128
    n_heads: int = 8
    p_dropout: float = 0.2
    kernel_size: int = 3
    dilation_rate: int = 2
    n_layers: int = 40
    dim_time_mult: Optional[int] = None
    block_out_channels: Tuple[int, ...] = (128, 256, 384, 512)
    n_prompt_layers: int = 4
    # >0 replaces every UNet transformer feed-forward with a top-k MoE
    # (parallel/moe.py) whose stacked expert kernels shard over an
    # 'expert'/'model' mesh axis. 0 = reference-parity dense GEGLU.
    moe_experts: int = 0
    moe_top_k: int = 2


@dataclasses.dataclass(frozen=True)
class VitsConfig:
    """VITS pre-model (model3.py:644-860) hyperparameters."""
    use_spk_conditioned_encoder: bool = True
    use_noise_scaled_mas: bool = True
    use_mel_posterior_encoder: bool = False
    use_duration_discriminator: bool = True
    inter_channels: int = 128
    hidden_channels: int = 256
    filter_channels: int = 256
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    n_layers_q: int = 4
    use_spectral_norm: bool = False
    gin_channels: int = 256
    # posterior encoder (hard-coded in the reference, model3.py:704-712)
    posterior_in_channels: int = 100
    posterior_kernel_size: int = 5
    posterior_dilation_rate: int = 1
    posterior_n_layers: int = 16
    # variant switches (model2/bv2 capability parity; model3 disables flow,
    # model3.py:762-763)
    use_flow: bool = False
    use_transformer_flow: bool = False
    n_flow_layer: int = 4
    n_layers_trans_flow: int = 6
    flow_share_parameter: bool = False
    # duration predictor selection: 'unet' (model3), 'conv' (classic VITS),
    # 'sdp' (stochastic) — model3.py:734-742
    duration_predictor: str = "unet"
    # bv2 variant: phoneme-level prosody VAE (bv2.py:540-775)
    use_phoneme_vae: bool = False
    # warmup steps before the phoneme VAE contributes (bv2.py:770-773)
    phoneme_vae_warmup_steps: int = 200_000
    mas_noise_scale_initial: float = 0.01
    noise_scale_delta: float = 2e-6


_KNOWN = {
    "train": TrainConfig,
    "data": DataConfig,
    "diffusion_encoder": DiffusionEncoderConfig,
    "vits": VitsConfig,
}


@dataclasses.dataclass(frozen=True)
class Config:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    diffusion_encoder: DiffusionEncoderConfig = dataclasses.field(
        default_factory=DiffusionEncoderConfig)
    vits: VitsConfig = dataclasses.field(default_factory=VitsConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        kwargs = {}
        for section, cls in _KNOWN.items():
            if section not in d:
                continue
            fields = {f.name for f in dataclasses.fields(cls)}
            vals = {}
            for k, v in d[section].items():
                if k == "betas" and section == "train":
                    # reference config.json has a stray 'betas' in train that
                    # duplicates adam_betas; accept both spellings
                    vals["adam_betas"] = tuple(v)
                elif k in fields:
                    vals[k] = tuple(v) if isinstance(v, list) else v
            kwargs[section] = cls(**vals)
        return Config(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
