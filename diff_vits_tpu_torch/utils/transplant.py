"""Reference torch state_dict -> flax-named parameter tree, numpy only.

The port's own copy of ``diff_vits_tpu/utils/transplant.py`` (every helper
from ``_get`` to ``diff_vits_params_from_config``, the same numpy
operations in the same order, so its trees are bitwise equal to the JAX
package's). It reads the PyTorch reference's checkpoints (model3's
``{'step', 'model': state_dict}``); ``utils/convert.from_flax_params``
then takes the tree to the port's state dict. Layout conventions:

  torch Conv1d weight [out, in, k]  -> flax nn.Conv kernel [k, in, out]
  torch Conv1d 1x1    [out, in, 1]  -> flax nn.Dense kernel [in, out]
  torch Linear        [out, in]     -> flax nn.Dense kernel [in, out]
  torch LayerNorm gamma/beta        -> flax LayerNorm scale/bias

Weight-norm reparameterizations (weight_g/weight_v) are collapsed into the
effective weight, since the modules store plain weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _get(state: Dict[str, Any], name: str) -> np.ndarray:
    w = state[name]
    try:
        w = w.detach().cpu().numpy()
    except AttributeError:
        w = np.asarray(w)
    return w.astype(np.float32)


def _j(prefix: str, name: str) -> str:
    """Join a state_dict prefix and key, tolerating empty prefixes."""
    return prefix + "." + name if prefix else name


def effective_weight(state: Dict[str, Any], prefix: str) -> np.ndarray:
    """Return the conv/linear weight, collapsing weight-norm if present."""
    if _j(prefix, f"weight") in state:
        return _get(state, _j(prefix, f"weight"))
    g = _get(state, _j(prefix, f"weight_g"))
    v = _get(state, _j(prefix, f"weight_v"))
    # torch weight_norm default dim=0: norm over all other dims per out-channel
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / norm


def conv1d(state, prefix) -> Dict[str, np.ndarray]:
    w = effective_weight(state, prefix)  # [out, in, k]
    p = {"kernel": np.transpose(w, (2, 1, 0))}
    if _j(prefix, f"bias") in state:
        p["bias"] = _get(state, _j(prefix, f"bias"))
    return p


def dense_from_conv1x1(state, prefix) -> Dict[str, np.ndarray]:
    w = effective_weight(state, prefix)  # [out, in, 1]
    p = {"kernel": w[:, :, 0].T}
    if _j(prefix, f"bias") in state:
        p["bias"] = _get(state, _j(prefix, f"bias"))
    return p


def dense_from_linear(state, prefix) -> Dict[str, np.ndarray]:
    w = effective_weight(state, prefix)  # [out, in]
    p = {"kernel": w.T}
    if _j(prefix, f"bias") in state:
        p["bias"] = _get(state, _j(prefix, f"bias"))
    return p


def layernorm_gamma_beta(state, prefix) -> Dict[str, np.ndarray]:
    """VITS-style LayerNorm with gamma/beta params (modules.py:17)."""
    return {"scale": _get(state, _j(prefix, f"gamma")),
            "bias": _get(state, _j(prefix, f"beta"))}


def layernorm(state, prefix) -> Dict[str, np.ndarray]:
    """torch nn.LayerNorm with weight/bias."""
    p = {}
    if _j(prefix, f"weight") in state:
        p["scale"] = _get(state, _j(prefix, f"weight"))
    if _j(prefix, f"bias") in state:
        p["bias"] = _get(state, _j(prefix, f"bias"))
    return p


def groupnorm(state, prefix) -> Dict[str, np.ndarray]:
    return {"scale": _get(state, _j(prefix, f"weight")),
            "bias": _get(state, _j(prefix, f"bias"))}


def embedding(state, prefix) -> Dict[str, np.ndarray]:
    return {"embedding": _get(state, _j(prefix, f"weight"))}


# ---------------------------------------------------------------------------
# Module-level transplants (names follow our linen module definitions)
# ---------------------------------------------------------------------------

def wn_params(state, prefix, n_layers, gin_channels=0) -> Dict[str, Any]:
    """modules.WN -> nn/layers.py:WN."""
    p: Dict[str, Any] = {}
    if gin_channels:
        p["cond_layer"] = dense_from_conv1x1(state, _j(prefix, f"cond_layer"))
    for i in range(n_layers):
        p[f"in_{i}"] = conv1d(state, _j(prefix, f"in_layers.{i}"))
        p[f"res_skip_{i}"] = dense_from_conv1x1(state, _j(prefix, f"res_skip_layers.{i}"))
    return p


def mha_params(state, prefix, window_size=None) -> Dict[str, Any]:
    """attentions.MultiHeadAttention -> nn/layers.py:MultiHeadAttention."""
    p = {
        "conv_q": dense_from_conv1x1(state, _j(prefix, f"conv_q")),
        "conv_k": dense_from_conv1x1(state, _j(prefix, f"conv_k")),
        "conv_v": dense_from_conv1x1(state, _j(prefix, f"conv_v")),
        "conv_o": dense_from_conv1x1(state, _j(prefix, f"conv_o")),
    }
    if window_size is not None:
        p["emb_rel_k"] = _get(state, _j(prefix, f"emb_rel_k"))
        p["emb_rel_v"] = _get(state, _j(prefix, f"emb_rel_v"))
    return p


def ffn_params(state, prefix) -> Dict[str, Any]:
    return {
        "conv_1": conv1d(state, _j(prefix, f"conv_1")),
        "conv_2": conv1d(state, _j(prefix, f"conv_2")),
    }


def encoder_params(state, prefix, n_layers, window_size=4,
                   has_spk=False) -> Dict[str, Any]:
    """attentions.Encoder -> nn/layers.py:Encoder."""
    p: Dict[str, Any] = {}
    if has_spk:
        p["spk_emb_linear"] = dense_from_linear(state, _j(prefix, f"spk_emb_linear"))
    for i in range(n_layers):
        p[f"attn_{i}"] = mha_params(state, _j(prefix, f"attn_layers.{i}"),
                                    window_size=window_size)
        p[f"norm1_{i}"] = layernorm_gamma_beta(state, _j(prefix, f"norm_layers_1.{i}"))
        p[f"ffn_{i}"] = ffn_params(state, _j(prefix, f"ffn_layers.{i}"))
        p[f"norm2_{i}"] = layernorm_gamma_beta(state, _j(prefix, f"norm_layers_2.{i}"))
    return p


def ddsconv_params(state, prefix, n_layers) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for i in range(n_layers):
        p[f"conv_sep_{i}"] = conv1d(state, _j(prefix, f"convs_sep.{i}"))
        p[f"conv_1x1_{i}"] = dense_from_conv1x1(state, _j(prefix, f"convs_1x1.{i}"))
        p[f"norm1_{i}"] = layernorm_gamma_beta(state, _j(prefix, f"norms_1.{i}"))
        p[f"norm2_{i}"] = layernorm_gamma_beta(state, _j(prefix, f"norms_2.{i}"))
    return p


# ---------------------------------------------------------------------------
# UNet1DConditionModel transplant (unet1d/ -> nn/unet1d.py)
# ---------------------------------------------------------------------------

def _resnet_params(state, prefix, has_shortcut):
    p = {
        "norm1": groupnorm(state, _j(prefix, f"norm1")),
        "conv1": conv1d(state, _j(prefix, f"conv1")),
        "time_emb_proj": dense_from_linear(state, _j(prefix, f"time_emb_proj")),
        "norm2": groupnorm(state, _j(prefix, f"norm2")),
        "conv2": conv1d(state, _j(prefix, f"conv2")),
    }
    if has_shortcut:
        p["conv_shortcut"] = dense_from_conv1x1(state, _j(prefix, f"conv_shortcut"))
    return p


def _cross_attention_params(state, prefix):
    return {
        "to_q": dense_from_linear(state, _j(prefix, f"to_q")),
        "to_k": dense_from_linear(state, _j(prefix, f"to_k")),
        "to_v": dense_from_linear(state, _j(prefix, f"to_v")),
        "to_out": dense_from_linear(state, _j(prefix, f"to_out.0")),
    }


def _transformer1d_params(state, prefix, num_layers=1, has_cross=True):
    p = {
        "norm": groupnorm(state, _j(prefix, f"norm")),
        "proj_in": dense_from_conv1x1(state, _j(prefix, f"proj_in")),
        "proj_out": dense_from_conv1x1(state, _j(prefix, f"proj_out")),
    }
    for i in range(num_layers):
        bp = _j(prefix, f"transformer_blocks.{i}")
        block = {
            "norm1": layernorm(state, f"{bp}.norm1"),
            "attn1": _cross_attention_params(state, f"{bp}.attn1"),
            "norm3": layernorm(state, f"{bp}.norm3"),
            "ff": {
                "proj": dense_from_linear(state, f"{bp}.ff.net.0.proj"),
                "out": dense_from_linear(state, f"{bp}.ff.net.2"),
            },
        }
        if has_cross:
            block["norm2"] = layernorm(state, f"{bp}.norm2")
            block["attn2"] = _cross_attention_params(state, f"{bp}.attn2")
        p[f"block_{i}"] = block
    return p


def _text_time_embedding_params(state, prefix):
    return {
        "norm1": layernorm(state, _j(prefix, f"norm1")),
        "pool": {
            "positional_embedding": _get(state, _j(prefix, f"pool.positional_embedding")),
            "q_proj": dense_from_linear(state, _j(prefix, f"pool.q_proj")),
            "k_proj": dense_from_linear(state, _j(prefix, f"pool.k_proj")),
            "v_proj": dense_from_linear(state, _j(prefix, f"pool.v_proj")),
        },
        "proj": dense_from_linear(state, _j(prefix, f"proj")),
        "norm2": layernorm(state, _j(prefix, f"norm2")),
    }


def unet_params(state, block_out_channels, layers_per_block=2,
                in_channels=None, prefix=""):
    """unet1d.UNet1DConditionModel state_dict -> our UNet1DConditionModel.

    Assumes the active architecture: CrossAttn x (n-1) + Down on the way
    down, CrossAttn mid, Up + CrossAttn x (n-1) on the way up.
    """
    pf = (prefix + ".") if prefix else ""
    ch = list(block_out_channels)
    n = len(ch)
    p = {
        "conv_in": conv1d(state, _j(prefix, f"conv_in")),
        "time_embedding": {
            "linear_1": dense_from_linear(state, _j(prefix, f"time_embedding.linear_1")),
            "linear_2": dense_from_linear(state, _j(prefix, f"time_embedding.linear_2")),
        },
        "conv_norm_out": groupnorm(state, _j(prefix, f"conv_norm_out")),
        "conv_out": conv1d(state, _j(prefix, f"conv_out")),
    }
    if any(k.startswith(_j(prefix, f"add_embedding.")) for k in state):
        p["add_embedding"] = _text_time_embedding_params(state, _j(prefix, f"add_embedding"))

    # down blocks
    for i in range(n):
        bp = _j(prefix, f"down_blocks.{i}")
        in_ch = ch[max(i - 1, 0)]
        blk = {}
        for j in range(layers_per_block):
            rin = in_ch if j == 0 else ch[i]
            blk[f"resnet_{j}"] = _resnet_params(
                state, f"{bp}.resnets.{j}", has_shortcut=rin != ch[i])
            if i < n - 1:  # cross-attn blocks
                blk[f"attn_{j}"] = _transformer1d_params(
                    state, f"{bp}.attentions.{j}")
        if f"{bp}.downsamplers.0.conv.weight" in state or \
           f"{bp}.downsamplers.0.conv.weight_g" in state:
            blk["downsample"] = {"conv": conv1d(state, f"{bp}.downsamplers.0.conv")}
        p[f"down_{i}"] = blk

    # mid
    p["mid"] = {
        "resnet_0": _resnet_params(state, _j(prefix, f"mid_block.resnets.0"), False),
        "attn_0": _transformer1d_params(state, _j(prefix, f"mid_block.attentions.0")),
        "resnet_1": _resnet_params(state, _j(prefix, f"mid_block.resnets.1"), False),
    }

    # up blocks
    rev = list(reversed(ch))
    prev_out = rev[0]
    for i in range(n):
        bp = _j(prefix, f"up_blocks.{i}")
        out_ch = rev[i]
        in_ch = rev[min(i + 1, n - 1)]
        blk = {}
        n_res = layers_per_block + 1
        for j in range(n_res):
            res_skip = in_ch if j == n_res - 1 else out_ch
            rin = (prev_out if j == 0 else out_ch) + res_skip
            blk[f"resnet_{j}"] = _resnet_params(
                state, f"{bp}.resnets.{j}", has_shortcut=rin != out_ch)
            if i > 0:  # cross-attn up blocks
                blk[f"attn_{j}"] = _transformer1d_params(
                    state, f"{bp}.attentions.{j}")
        if f"{bp}.upsamplers.0.conv.weight" in state or \
           f"{bp}.upsamplers.0.conv.weight_g" in state:
            blk["upsample"] = {"conv": conv1d(state, f"{bp}.upsamplers.0.conv")}
        p[f"up_{i}"] = blk
        prev_out = out_ch
    return p


# ---------------------------------------------------------------------------
# Fairseq-stack transplants (operations.py / model.py -> nn/fairseq.py)
# ---------------------------------------------------------------------------

def ffn1_conv_params(state, prefix, kernel_size):
    """Reassemble TransformerFFNLayer's k shifted Linears into one conv.

    operations.py:664-682: out[t] = sum_i Linear_i(x_shifted_i[t]) * k^-0.5.
    Taps i >= 1 use offset i - (k-1)//2; tap 0 uses the UNSHIFTED input
    (``shifted = padded[i:T+i] if i else x``) — a reference quirk that puts
    Linear_0 at the center offset (stacked onto Linear_{(k-1)//2}) and
    leaves offset -(k-1)//2 empty. Only Linear_0 has a bias.
    """
    ws = [_get(state, _j(prefix, f"ffn_1.{i}.weight"))
          for i in range(kernel_size)]
    center = (kernel_size - 1) // 2
    taps = [np.zeros_like(ws[0].T)] + [w.T for w in ws[1:]]
    taps[center] = taps[center] + ws[0].T
    kernel = np.stack(taps, axis=0)  # [k, in, out]
    return {"kernel": kernel, "bias": _get(state, _j(prefix, "ffn_1.0.bias"))}


def conv_tbc(state, prefix):
    """ConvTBC weight [k, in, out] is already in flax layout (model.py:137)."""
    p = {"kernel": effective_weight(state, prefix)}
    if _j(prefix, "bias") in state:
        p["bias"] = _get(state, _j(prefix, "bias"))
    return p


def conv_layer_params(state, prefix):
    """model.ConvLayer (LN + ConvTBC) -> nn/fairseq.py:ConvLayer."""
    return {
        "layer_norm": layernorm(state, _j(prefix, "layer_norm")),
        "conv": conv_tbc(state, _j(prefix, "conv")),
    }


def enc_sa_layer_params(state, prefix, ffn_kernel=9):
    """operations.EncSALayer -> nn/fairseq.py:EncSALayer."""
    return {
        "layer_norm1": layernorm(state, _j(prefix, "layer_norm1")),
        "layer_norm2": layernorm(state, _j(prefix, "layer_norm2")),
        "in_proj": {"kernel": _get(
            state, _j(prefix, "self_attn.in_proj_weight")).T},
        "out_proj": dense_from_linear(state, _j(prefix, "self_attn.out_proj")),
        "ffn": {
            "ffn_1": ffn1_conv_params(state, _j(prefix, "ffn"), ffn_kernel),
            "ffn_2": dense_from_linear(state, _j(prefix, "ffn.ffn_2")),
        },
    }


def prompt_encoder_params(state, prefix, n_layers, has_g=False):
    """model3.PromptEncoder -> models/encoders.py:PromptEncoder."""
    p = {
        "pre": conv_layer_params(state, _j(prefix, "pre")),
        "out_proj": conv_layer_params(state, _j(prefix, "out_proj")),
        "layer_norm": layernorm(state, _j(prefix, "layer_norm")),
    }
    if has_g:
        p["g_proj"] = dense_from_conv1x1(state, _j(prefix, "g_proj"))
    for i in range(n_layers):
        p[f"layer_{i}"] = enc_sa_layer_params(
            state, _j(prefix, f"layers.{i}.op"))
    return p


# ---------------------------------------------------------------------------
# Full-model transplants (model3.py -> models/)
# ---------------------------------------------------------------------------

def text_encoder_params(state, prefix, n_layers):
    return {
        "emb": embedding(state, _j(prefix, "emb")),
        "tone_emb": embedding(state, _j(prefix, "tone_emb")),
        "language_emb": embedding(state, _j(prefix, "language_emb")),
        "encoder": encoder_params(state, _j(prefix, "encoder"), n_layers,
                                  window_size=4, has_spk=True),
        "proj": dense_from_conv1x1(state, _j(prefix, "proj")),
    }


def posterior_encoder_params(state, prefix, n_layers, gin):
    return {
        "pre": dense_from_conv1x1(state, _j(prefix, "pre")),
        "enc": wn_params(state, _j(prefix, "enc"), n_layers,
                         gin_channels=gin),
        "proj": dense_from_conv1x1(state, _j(prefix, "proj")),
    }


def duration_predictor_unet_params(state, prefix, hidden=256):
    block_out = (hidden // 4, hidden // 4, hidden // 2, hidden // 2)
    return {
        "prompt_proj": dense_from_conv1x1(state, _j(prefix, "prompt_proj")),
        "pre": dense_from_conv1x1(state, _j(prefix, "pre")),
        "enc": unet_params(state, block_out, prefix=_j(prefix, "enc")),
    }


def vits_params(state, prefix="vits", n_layers_enc=6, posterior_layers=16,
                gin=256, o_proj_layers=6):
    """model3.VITS state_dict -> models/vits.py:VITS params."""
    return {
        "enc_p": text_encoder_params(state, _j(prefix, "enc_p"), n_layers_enc),
        "enc_q": posterior_encoder_params(
            state, _j(prefix, "enc_q"), posterior_layers, gin),
        "ref_enc": _text_time_embedding_params(state, _j(prefix, "ref_enc")),
        "dp": duration_predictor_unet_params(state, _j(prefix, "dp")),
        "o_proj": prompt_encoder_params(
            state, _j(prefix, "o_proj"), o_proj_layers, has_g=True),
    }


def diffusion_encoder_params(state, prefix="diff_model",
                             block_out=(128, 256, 384, 512),
                             n_prompt_layers=4):
    return {
        "prompt_encoder": prompt_encoder_params(
            state, _j(prefix, "prompt_encoder"), n_prompt_layers),
        "unet": unet_params(state, block_out, prefix=_j(prefix, "unet")),
    }


def diff_vits_params(state, **kwargs):
    """Full NaturalSpeech2 checkpoint (model3.py:954) -> DiffVits params."""
    return {
        "vits": vits_params(state, "vits", **{
            k: v for k, v in kwargs.items()
            if k in ("n_layers_enc", "posterior_layers", "gin",
                     "o_proj_layers")}),
        "diff_model": diffusion_encoder_params(state, "diff_model", **{
            k: v for k, v in kwargs.items()
            if k in ("block_out", "n_prompt_layers")}),
    }


def diff_vits_params_from_config(state, cfg):
    """Config-driven transplant: derive the per-module layer counts from a
    ``core.config.Config`` instead of the reference defaults."""
    return diff_vits_params(
        state,
        n_layers_enc=cfg.vits.n_layers,
        posterior_layers=cfg.vits.posterior_n_layers,
        gin=cfg.vits.gin_channels,
        block_out=tuple(cfg.diffusion_encoder.block_out_channels),
        n_prompt_layers=cfg.diffusion_encoder.n_prompt_layers,
    )
