"""Every block type the port's ``get_down_block`` / ``get_up_block``
build (11 down, 11 up) against the JAX package's (CPU, float32, atol =
rtol = 1e-5), at C = 32, 4 GN groups, 4 heads of 8, as
``tests/test_block_zoo.py`` builds them, every output (skip lists and skip
streams included) compared; the model's own block types on both routes,
the blocks without resampling, the resnet resamplers, the K blocks'
channel rules and the factories' names.
"""
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn import unet1d_blocks as Z
from diff_vits_tpu_torch.nn import unet1d_blocks as P
from test_torch_offpath_blocks import B, S, T, run_both

torch.set_num_threads(2)


DOWN_TYPES = ["DownBlock2D", "ResnetDownsampleBlock2D", "AttnDownBlock2D",
              "CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D",
              "SkipDownBlock2D", "AttnSkipDownBlock2D", "DownEncoderBlock2D",
              "AttnDownEncoderBlock2D", "KDownBlock2D",
              "KCrossAttnDownBlock2D"]
UP_TYPES = ["UpBlock2D", "ResnetUpsampleBlock2D", "CrossAttnUpBlock2D",
            "SimpleCrossAttnUpBlock2D", "AttnUpBlock2D", "SkipUpBlock2D",
            "AttnSkipUpBlock2D", "UpDecoderBlock2D", "AttnUpDecoderBlock2D",
            "KUpBlock2D", "KCrossAttnUpBlock2D"]
_C_IN, _C_OUT, _TEMB, _XDIM = 32, 32, 32, 24
FACTORY = dict(resnet_groups=4, cross_attention_dim=_XDIM,
               num_attention_heads=4, attention_head_dim=8)


def down_args(t, rng_seed=2):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(B, T, _C_IN)).astype(np.float32)
    temb = rng.normal(size=(B, _TEMB)).astype(np.float32)
    ctx = rng.normal(size=(B, S, _XDIM)).astype(np.float32)
    skip = rng.normal(size=(B, T, 3)).astype(np.float32)
    if t in ("DownEncoderBlock2D", "AttnDownEncoderBlock2D"):
        return [x]
    if t in ("SkipDownBlock2D", "AttnSkipDownBlock2D"):
        return [x, temb, skip]
    if t in ("CrossAttnDownBlock2D", "SimpleCrossAttnDownBlock2D",
             "KCrossAttnDownBlock2D"):
        return [x, temb, ctx]
    return [x, temb]


def up_args(t, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(B, T, _C_OUT)).astype(np.float32)
    temb = rng.normal(size=(B, _TEMB)).astype(np.float32)
    ctx = rng.normal(size=(B, S, _XDIM)).astype(np.float32)
    # the skip stream enters one resolution coarser than the hidden states
    skip = rng.normal(size=(B, T // 2, 3)).astype(np.float32)
    stack = [rng.normal(size=(B, T, _C_IN)).astype(np.float32),
             rng.normal(size=(B, T, _C_OUT)).astype(np.float32)]
    if t in ("UpDecoderBlock2D", "AttnUpDecoderBlock2D"):
        return [x, temb]
    if t in ("SkipUpBlock2D", "AttnSkipUpBlock2D"):
        return [x, stack, temb, skip]
    if t == "KUpBlock2D":
        return [x, x, temb]
    if t == "KCrossAttnUpBlock2D":
        # in == out == temb: the k-unet's first block, its skip None
        return [x, None, temb, ctx]
    if t in ("CrossAttnUpBlock2D", "SimpleCrossAttnUpBlock2D"):
        return [x, stack, temb, ctx]
    return [x, stack, temb]


@pytest.mark.parametrize("block_type", DOWN_TYPES)
def test_factory_down_block_matches_jax(block_type):
    jm = Z.get_down_block(block_type, 2, _C_IN, _C_OUT, _TEMB, True,
                          **FACTORY)
    pm = P.get_down_block(block_type, 2, _C_IN, _C_OUT, _TEMB, True,
                          **FACTORY)
    assert type(pm).__name__ == type(jm).__name__
    got = run_both(jm, pm, *down_args(block_type))
    x = got if isinstance(got, torch.Tensor) else got[0]
    assert x.shape == (B, T // 2, _C_OUT)


@pytest.mark.parametrize("block_type", UP_TYPES)
def test_factory_up_block_matches_jax(block_type):
    jm = Z.get_up_block(block_type, 2, _C_IN, _C_OUT, _C_OUT, _TEMB, True,
                        **FACTORY)
    pm = P.get_up_block(block_type, 2, _C_IN, _C_OUT, _C_OUT, _TEMB, True,
                        **FACTORY)
    assert type(pm).__name__ == type(jm).__name__
    got = run_both(jm, pm, *up_args(block_type))
    x = got if isinstance(got, torch.Tensor) else got[0]
    assert x.shape[1] == 2 * T


@pytest.mark.parametrize("block_type", ["DownBlock2D", "CrossAttnDownBlock2D",
                                        "UpBlock2D", "CrossAttnUpBlock2D"])
def test_factory_model_blocks_match_jax_on_the_unfused_route(block_type):
    """The model's own blocks, which take K1-K4 on the card, also on their
    unfused formulation."""
    if block_type.startswith("Down") or block_type.startswith("CrossAttnD"):
        jm = Z.get_down_block(block_type, 2, _C_IN, _C_OUT, _TEMB, True,
                              **FACTORY)
        pm = P.get_down_block(block_type, 2, _C_IN, _C_OUT, _TEMB, True,
                              **FACTORY)
        args = down_args(block_type)
    else:
        jm = Z.get_up_block(block_type, 2, _C_IN, _C_OUT, _C_OUT, _TEMB,
                            True, **FACTORY)
        pm = P.get_up_block(block_type, 2, _C_IN, _C_OUT, _C_OUT, _TEMB,
                            True, **FACTORY)
        args = up_args(block_type)
    run_both(jm, pm, *args, fused=False)


@pytest.mark.parametrize("add", [False, True])
def test_factory_blocks_without_resampling_match_jax(add):
    """add_downsample / add_upsample False: the K blocks' self-attention
    and None skips, the Attn blocks' missing resampler."""
    for t in ("KCrossAttnDownBlock2D", "AttnDownBlock2D", "SkipDownBlock2D"):
        jm = Z.get_down_block(t, 1, _C_IN, _C_OUT, _TEMB, add, **FACTORY)
        pm = P.get_down_block(t, 1, _C_IN, _C_OUT, _TEMB, add, **FACTORY)
        run_both(jm, pm, *down_args(t))
    for t in ("AttnUpBlock2D", "KUpBlock2D"):
        jm = Z.get_up_block(t, 2, _C_IN, _C_OUT, _C_OUT, _TEMB, add,
                            **FACTORY)
        pm = P.get_up_block(t, 2, _C_IN, _C_OUT, _C_OUT, _TEMB, add,
                            **FACTORY)
        run_both(jm, pm, *up_args(t))


def test_factory_resnet_resamplers_match_jax():
    kw = dict(FACTORY, downsample_type="resnet")
    jm = Z.get_down_block("AttnDownBlock2D", 1, _C_IN, _C_OUT, _TEMB, True,
                          **kw)
    pm = P.get_down_block("AttnDownBlock2D", 1, _C_IN, _C_OUT, _TEMB, True,
                          **kw)
    run_both(jm, pm, *down_args("AttnDownBlock2D"))
    kw = dict(FACTORY, upsample_type="resnet")
    jm = Z.get_up_block("AttnUpBlock2D", 1, _C_IN, _C_OUT, _C_OUT, _TEMB,
                        True, **kw)
    pm = P.get_up_block("AttnUpBlock2D", 1, _C_IN, _C_OUT, _C_OUT, _TEMB,
                        True, **kw)
    args = up_args("AttnUpBlock2D")
    args[1] = args[1][1:]
    run_both(jm, pm, *args)


def test_factory_k_cross_up_middle_block_matches_jax():
    """in != out: the k-unet's middle block (2 out skip width in, a last
    conv of width in)."""
    jm = Z.get_up_block("KCrossAttnUpBlock2D", 3, 16, _C_OUT, _C_OUT, _TEMB,
                        True, **FACTORY)
    pm = P.get_up_block("KCrossAttnUpBlock2D", 3, 16, _C_OUT, _C_OUT, _TEMB,
                        True, **FACTORY)
    x, _, temb, ctx = up_args("KCrossAttnUpBlock2D")
    got = run_both(jm, pm, x, x, temb, ctx)
    assert got.shape == (B, 2 * T, 16)


def test_factory_unknown_raises():
    with pytest.raises(ValueError, match="does not exist"):
        P.get_down_block("NoSuchBlock2D", 1, 8, 8, 8, True)
    with pytest.raises(ValueError, match="does not exist"):
        P.get_up_block("NoSuchBlock2D", 1, 8, 8, 8, 8, True)
    with pytest.raises(ValueError, match="cross_attention_dim"):
        P.get_down_block("CrossAttnDownBlock2D", 1, 8, 8, 8, True)
    with pytest.raises(ValueError, match="cross_attention_dim"):
        P.get_up_block("SimpleCrossAttnUpBlock2D", 1, 8, 8, 8, 8, True)


@pytest.mark.parametrize("name", ["UNetResDownBlock2D", "DownBlock1D",
                                  "DownBlock2D"])
def test_factory_accepts_unetres_prefix_and_1d_names(name):
    m = P.get_down_block(name, 1, 8, 8, 8, True, resnet_groups=4)
    assert type(m).__name__ == "DownBlock1D"
    assert P._canon(name) == Z._canon(name)
    u = P.get_up_block(name.replace("Down", "Up"), 1, 8, 8, 8, 8, True,
                       resnet_groups=4)
    assert type(u).__name__ == "UpBlock1D"
