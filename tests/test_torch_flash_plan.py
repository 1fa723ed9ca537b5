"""The plan of K8's kernels (``ops/_cuda.flash_plan``, csrc/flash_attention.cu)
at every shape a training step gives them, the head-dim route rule, the
route counters and the alignment refusal, all decided on the host.

The gated shapes are derived, not listed: ``DiffVits.forward`` of
``configs/reference_parity.json`` (model3, and the variant with the
stochastic duration predictor and the residual-coupling flow) runs on the
meta device in training mode (shapes only) at the training batch (32),
text 601, mel 400 and prompts 267, with the flash route on and every call
of ``sdpa`` recorded instead of run (MAS and dropout stubbed: they do not
change a shape). Model3 makes 40 such calls a step, the variant 20, as
``chip_smoke.py`` counts on the card; the bv2 variant (that variant
with the phoneme VAE) 24. At each of them, in bfloat16: the
tensor-core kernels (head dims 8, 16, 32) with 64-row tiles on both sides
and at least 1,280 blocks a grid (no key splits needed); in float32 the
FMA kernels with 128 rows. Then ragged and tiny shapes (T or S below 16,
not multiples of 16 or 64): the widest tile whose grid reaches the 132
SMs, else 16 rows. The rule of routes: bfloat16 up to d = 64 on tensor
cores, float32 and wider bfloat16 on the FMA kernels, each launch counted
by route. The views the tensor-core kernels refuse: a start not 16-byte
aligned, a batch, head or row stride that is no multiple of 8 elements.
"""
import dataclasses
from pathlib import Path
from unittest import mock

import pytest
import torch

import chip_smoke
from diff_vits_tpu_torch import ops
from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models import duration as tduration
from diff_vits_tpu_torch.models import vits as tvits
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.nn import fairseq, layers, unet1d
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import flash_attention as FA
from diff_vits_tpu_torch.text.symbols import symbols

torch.set_num_threads(2)

CFG = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                      / "reference_parity.json"))
VARIANT = dataclasses.replace(CFG, vits=dataclasses.replace(
    CFG.vits, duration_predictor="sdp", use_flow=True))
BV2 = dataclasses.replace(VARIANT, vits=dataclasses.replace(
    VARIANT.vits, use_phoneme_vae=True))
META = torch.device("meta")
SMS = 132
DTYPES = [torch.float32, torch.bfloat16]


def _gated_calls(cfg):
    """(B, T, S, H, d, masked) of every ``sdpa`` call of one training
    forward of ``cfg`` with the flash route on."""
    calls = []

    def sdpa(q, k, v, keep=None, *, sm_scale, use_flash=False):
        assert use_flash and FA.flash_ok(q.shape, k.shape, use_flash)
        calls.append((q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                      q.shape[3], keep is not None))
        return torch.empty_like(q)

    def no_dropout(x, p, training, generator=None):
        return x

    def alignment(self, z_p, m_p, logs_p, attn_mask, *args):
        return torch.empty_like(attn_mask)

    with torch.device(META):
        model = DiffVits(cfg, len(symbols), device=META).train()
    unet1d.set_use_flash(model, True)
    b, t_y = cfg.train.train_batch_size, cfg.data.max_mel_len
    t_x = cfg.data.max_text_len * 2 + 1
    s = t_y * 2 // 3 + 1                     # the loader's prompt slice

    def r(*shape):
        return torch.empty(*shape, device=META)

    def lengths(n):
        return torch.full((b,), n, dtype=torch.long, device=META)
    text = torch.zeros(b, t_x, dtype=torch.long, device=META)
    patches = [mock.patch.object(unet1d, "sdpa", sdpa),
               mock.patch.object(fairseq, "sdpa", sdpa),
               mock.patch.object(tvits.VITS, "_alignment", alignment)]
    patches += [mock.patch.object(m, "dropout", no_dropout)
                for m in (layers, fairseq, tduration)]
    for p in patches:
        p.start()
    try:
        model(text, lengths(t_x), r(b, t_y, 100), lengths(t_y),
              r(b, s, 100), lengths(s), text, text,
              t=torch.zeros(b, dtype=torch.long, device=META),
              noise=r(b, t_y, 100), dur_noise=r(b, t_x, 2))
    finally:
        for p in patches:
            p.stop()
    return calls


@pytest.fixture(scope="module")
def gated():
    return {"model3": _gated_calls(CFG), "variant": _gated_calls(VARIANT),
            "bv2": _gated_calls(BV2)}


def test_gated_calls_of_a_training_step(gated):
    # chip_smoke.py's counters: 40 + 40 K8 launches a model3 step, 20 + 20
    # a variant step
    assert len(gated["model3"]) == 40
    assert len(gated["variant"]) == 20
    assert set(gated["variant"]) <= set(gated["model3"])
    shapes = {(t, s, d, masked) for _, t, s, _, d, masked in gated["model3"]}
    for _, t, s, d, ragged in chip_smoke.FLASH_SITES:
        assert (t, s, d, ragged) in shapes
    assert {d for _, _, d, _ in shapes} == {8, 16, 32}


def test_gated_calls_of_a_bv2_training_step(gated):
    """The variant's 20 and the phoneme prior encoder's 4 layers on the
    text buffer (T = S = 601, 8 heads of 32), as chip_smoke.py derives
    them for its bv2 phase."""
    assert len(gated["bv2"]) == chip_smoke.bv2_flash_sites(BV2) == 24
    extra = list(gated["bv2"])
    for call in gated["variant"]:
        extra.remove(call)
    assert extra == [(32, 601, 601, 8, 32, True)] * 4


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("model", ["model3", "variant", "bv2"])
def test_flash_plan_at_every_gated_site(gated, model, dtype):
    for b, t, s, h, d, _ in gated[model]:
        plan = _cuda.flash_plan(b, t, s, h, d, dtype)
        if dtype == torch.float32:
            assert plan == _cuda.FlashPlan(128, 128, False)
            continue
        assert plan == _cuda.FlashPlan(64, 64, True), (t, s, d)
        for n in (t, s):
            assert -(-n // plan.q_rows) * h * b >= 1280


def _grid(n, rows, h, b):
    return -(-n // rows) * h * b


@pytest.mark.parametrize("b,t,s,h,d", [
    (1, 1, 1, 1, 8),          # one query, one key
    (3, 7, 11, 2, 24),        # T, S below one 16-row warp tile
    (3, 37, 29, 2, 40),
    (2, 129, 130, 2, 16),     # past a 64-row tile and a 128-row block
    (4, 65, 63, 2, 56),
    (2, 300, 5, 8, 32),
    (1, 601, 400, 1, 8),      # one item, one head
    (2, 17, 600, 1, 64),
    (1, 400, 400, 8, 16),     # b=1: 56 blocks of 64 rows
    (2, 133, 9, 8, 48),
])
def test_flash_plan_on_ragged_and_tiny_shapes(b, t, s, h, d):
    plan = _cuda.flash_plan(b, t, s, h, d, torch.bfloat16)
    assert plan.tensor_cores
    for n, rows in ((t, plan.q_rows), (s, plan.k_rows)):
        assert rows in _cuda.FLASH_ROWS
        wider = [r for r in _cuda.FLASH_ROWS if r > rows]
        # the widest tile that reaches the SMs; 16 rows when none does
        assert all(_grid(n, r, h, b) < SMS for r in wider)
        assert _grid(n, rows, h, b) >= SMS or rows == 16
    assert _cuda.flash_plan(b, t, s, h, d, torch.float32) == \
        _cuda.FlashPlan(128, 128, False)


def test_flash_plan_picks_these_tiles():
    bf = torch.bfloat16
    assert _cuda.flash_plan(1, 1, 1, 1, 8, bf) == _cuda.FlashPlan(16, 16, True)
    assert _cuda.flash_plan(1, 400, 400, 8, 16, bf) == \
        _cuda.FlashPlan(16, 16, True)        # 200 blocks of 16 rows
    assert _cuda.flash_plan(1, 601, 400, 8, 8, bf) == \
        _cuda.FlashPlan(32, 16, True)        # 152 / 200 blocks
    assert _cuda.flash_plan(4, 400, 267, 8, 16, bf) == \
        _cuda.FlashPlan(64, 64, True)        # 224 / 160 blocks
    assert _cuda.flash_plan(32, 601, 601, 8, 8, bf) == \
        _cuda.FlashPlan(64, 64, True)        # 2,560 blocks of 64 rows


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_head_dim_route_rule(d):
    bf = _cuda.flash_plan(2, 50, 60, 2, d, torch.bfloat16)
    assert bf.tensor_cores == (d <= 64)
    assert (d in FA.MMA_HEAD_DIMS) == (d <= 64)
    assert not _cuda.flash_plan(2, 50, 60, 2, d, torch.float32).tensor_cores
    if not bf.tensor_cores:
        assert (bf.q_rows, bf.k_rows) == (128, 128)


def test_flash_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        _cuda.flash_plan(1, 8, 8, 1, 8, torch.float16)
    for d in (0, 12, 136):
        with pytest.raises(ValueError, match="head dims"):
            _cuda.flash_plan(1, 8, 8, 1, d, torch.bfloat16)
    with pytest.raises(ValueError, match=">= 1"):
        _cuda.flash_plan(1, 0, 8, 1, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        _cuda.flash_plan(65536, 8, 8, 1, 8, torch.bfloat16)


@pytest.mark.parametrize("dtype,d,route,wide", [
    (torch.bfloat16, 32, "mma", 0), (torch.bfloat16, 72, "fma", 1),
    (torch.float32, 32, "fma", 0), (torch.float32, 128, "fma", 0)],
    ids=["bf16", "bf16_wide", "fp32", "fp32_wide"])
def test_route_counters(dtype, d, route, wide):
    ops.reset_launches()
    plan = _cuda.flash_plan(2, 50, 60, 2, d, dtype)
    for launcher in FA.LAUNCHERS:
        FA._count(launcher, plan, dtype)
    counts = FA.route_counts()
    other = "fma" if route == "mma" else "mma"
    for name in ("flash_attention_forward", "flash_attention_backward"):
        assert ops.launch_counts()[name] == 1
        assert counts[f"{name}.{route}_launches"] == 1
        assert counts[f"{name}.{other}_launches"] == 0
        assert counts[f"{name}.wide_bf16_launches"] == wide
    ops.reset_launches()
    assert not any(FA.route_counts().values())
    assert not any(ops.launch_counts().values())


def test_alignment_refusal_on_the_host():
    b, t, h, d = 2, 9, 4, 8
    qkv = torch.zeros(b, t, 3 * h * d, dtype=torch.bfloat16)
    heads = [x.unflatten(-1, (h, d)).transpose(1, 2)
             for x in qkv.chunk(3, dim=-1)]
    assert all(FA.mma_view_ok(x) for x in heads)   # EncSALayer's views
    FA.check_mma_views(q=heads[0], k=heads[1], v=heads[2])
    flat = torch.zeros(b * h * t * d + 8, dtype=torch.bfloat16)
    shifted = flat[1:b * h * t * d + 1].view(b, h, t, d)   # 2 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.check_mma_views(q=shifted)
    row20 = torch.zeros(b, h, t, 20, dtype=torch.bfloat16)[..., :d]
    batch_odd = torch.zeros(b * (h * t * d + 4), dtype=torch.bfloat16)
    batch_odd = batch_odd.view(b, -1)[:, :h * t * d].view(b, h, t, d)
    for name, x in (("k", row20), ("v", batch_odd)):
        assert not FA.mma_view_ok(x)
        with pytest.raises(ValueError, match=f"{name}: the tensor-core"):
            FA.check_mma_views(**{name: x})
