"""The plan of K5's attention core (csrc/rel_attention.cu) at every shape
the main path gives it.

``_cuda.rel_attention_plan`` is checked at every K5 shape of the main
path, derived, not listed: the TextEncoder of model3
(``configs/reference_parity.json``) and the transformer-coupling flow of
the variant that has one run on the meta device (shapes only), with
``MultiHeadAttention`` sent down its kernel route and each
``fused_rel_self_attention`` call recorded instead of launched, at batch 1
and 8 and the serving buckets (text 128 and 601; the flow over mel 400 and
800). In bfloat16 (tensor cores): at most 8 splits (one cluster), none
without keys as the kernel splits a full row of keys, and the grid
reaching the H100's 132 SMs wherever 64-, 32- or 16-row tiles and up to 8
splits allow it, splitting no further than one block an SM (the attention
core's rule, ``attention_plan``); float32 keeps the FMA kernel's 16 rows
and one split. The plan refuses what the kernels do not take.
"""
import dataclasses
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import pytest
import torch

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.encoders import TextEncoder
from diff_vits_tpu_torch.models.flow import TransformerCouplingBlock
from diff_vits_tpu_torch.nn import layers
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import rel_attention as RA

torch.set_num_threads(2)

CFG = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                      / "reference_parity.json"))
VARIANT = dataclasses.replace(CFG.vits, duration_predictor="sdp",
                              use_flow=True, use_transformer_flow=True)
BATCHES = (1, 8)
TEXT_BUCKETS = (128, 601)
MEL_BUCKETS = (400, 800)
META = torch.device("meta")
SMS = 132


def _recording(calls):
    """Patches under which MultiHeadAttention takes its kernel route on
    meta tensors and each K5 call is recorded as (B, T, H, D, window)."""
    def k5(x, lengths, *args, heads, window, compute_dtype):
        b, t, c = x.shape
        calls.append((b, t, heads, c // heads, window))
        return torch.empty(b, t, args[6].shape[-1], device=x.device,
                           dtype=x.dtype)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(layers, "fused_rel_self_attention",
                                          k5))
    stack.enter_context(mock.patch.object(
        layers.MultiHeadAttention, "_fused_enabled", lambda self, x: True))
    return stack


def _k5_runs():
    """{site: K5 calls of one forward}."""
    v = CFG.vits
    with torch.device(META):
        text = TextEncoder(100, v.inter_channels, v.hidden_channels,
                           v.filter_channels, v.n_heads, v.n_layers,
                           v.kernel_size, device=META).eval()
        w = VARIANT
        flow = TransformerCouplingBlock(
            w.inter_channels, w.hidden_channels, w.filter_channels,
            w.n_heads, w.n_layers_trans_flow, 5, 0.0, w.n_flow_layer,
            gin_channels=w.gin_channels, device=META).eval()
    out = {}
    for b in BATCHES:
        for t in TEXT_BUCKETS:
            calls = []
            ids = torch.zeros(b, t, dtype=torch.long, device=META)
            with _recording(calls), torch.no_grad():
                text(ids, torch.full((b,), t, device=META), ids, ids)
            out[f"text-encoder-b{b}-T{t}"] = calls
        for t in MEL_BUCKETS:
            calls = []
            with _recording(calls), torch.no_grad():
                flow(torch.empty(b, t, w.inter_channels, device=META),
                     torch.ones(b, t, 1, device=META),
                     g=torch.empty(b, 1, w.gin_channels, device=META),
                     reverse=True)
            out[f"transformer-flow-b{b}-T{t}"] = calls
    return out


K5_RUNS = _k5_runs()


def _shapes():
    seen = {}
    for site, calls in K5_RUNS.items():
        for shape in calls:
            seen.setdefault(shape, site)
    return [pytest.param(shape, id=f"{site}-B{shape[0]}-T{shape[1]}-"
                         f"H{shape[2]}-d{shape[3]}-w{shape[4]}")
            for shape, site in seen.items()]


def _max_splits(t):
    n = 1
    while 2 * n <= min(8, -(-t // 16)):
        n *= 2
    return n


def test_derivation_walks_every_k5_call():
    """The TextEncoder launches K5 once a layer (6, the count chip_smoke.py
    holds serving to); the transformer flow once a layer of each of its
    couplings; every call at 2 heads of 128 and window 4."""
    v = CFG.vits
    for site, calls in K5_RUNS.items():
        want = (v.n_layers if site.startswith("text")
                else VARIANT.n_layers_trans_flow * VARIANT.n_flow_layer)
        b, t = (int(x[1:]) for x in site.split("-")[-2:])
        assert len(calls) == want, site
        assert set(calls) == {(b, t, 2, 128, 4)}, site


@pytest.mark.parametrize("shape", _shapes())
def test_plan_fills_the_card_with_keys_in_every_split(shape):
    b, t, h, d, _ = shape

    def grid(rows, splits):
        return -(-t // rows) * h * b * splits

    assert _cuda.rel_attention_plan(b, t, h, d, torch.float32) == \
        _cuda.RelAttentionPlan(16, 1, False)
    plan = _cuda.rel_attention_plan(b, t, h, d, torch.bfloat16)
    assert plan.tensor_cores and plan.rows in (64, 32, 16)
    assert plan.splits in (1, 2, 4, 8)              # one cluster <= 8 blocks
    chunks = -(-t // 16)
    for r in range(plan.splits):             # as csrc/rel_attention.cu
        lo = r * chunks // plan.splits * 16
        hi = min((r + 1) * chunks // plan.splits * 16, t)
        assert hi > lo, (r, lo, hi)
    most = max(grid(rows, _max_splits(t)) for rows in (64, 32, 16))
    assert grid(plan.rows, plan.splits) >= min(SMS, most)
    wider = [rows for rows in (64, 32) if rows > plan.rows]
    assert all(grid(rows, _max_splits(t)) < SMS for rows in wider)
    if plan.splits > 1:
        assert grid(plan.rows, plan.splits // 2) < SMS
    # the attention core's rule, keys = queries
    assert plan[:2] == _cuda._split_plan(b, t, t, h)


def test_plan_headline_shapes():
    """b=8 T=601: 64-row tiles, 160 blocks, no split; b=1 T=128: 16-row
    tiles in 8 splits (128 blocks); b=1 T=601: 64-row tiles in 8 splits."""
    bf16 = torch.bfloat16
    assert _cuda.rel_attention_plan(8, 601, 2, 128, bf16) == \
        _cuda.RelAttentionPlan(64, 1, True)
    assert _cuda.rel_attention_plan(1, 128, 2, 128, bf16) == \
        _cuda.RelAttentionPlan(16, 8, True)
    assert _cuda.rel_attention_plan(1, 601, 2, 128, bf16) == \
        _cuda.RelAttentionPlan(64, 8, True)


@pytest.mark.parametrize("args,error", [
    ((1, 8, 2, 128, torch.float16), TypeError),
    ((1, 8, 2, 24, torch.bfloat16), ValueError),      # head dim
    ((1, 8, 2, 48, torch.float32), ValueError),       # not a K5 head dim
    ((0, 8, 2, 128, torch.bfloat16), ValueError),     # empty batch
    ((1, 0, 2, 128, torch.bfloat16), ValueError),     # no row
    ((1, 8, 65536, 8, torch.bfloat16), ValueError),   # grid y
], ids=["float16", "head-dim", "head-dim-48", "empty", "no-row", "heads"])
def test_plan_refuses_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        _cuda.rel_attention_plan(*args)


def test_wrapper_head_dims_are_the_plans():
    assert RA.HEAD_DIMS == _cuda.REL_HEAD_DIMS
