"""The attention core of K2 and K3: its plain version against the JAX
package, and the plan of csrc/attention.cu at every shape the main path
gives it.

``attention_plain`` (ops/fused_transformer.py) is held against the JAX
package's batched twin ``_xla_mha`` (diff_vits_tpu/ops/fused_transformer.py
:99) with identity q, k and output projections, a permutation for v and a
zero output bias, so that ``_xla_mha`` reduces to its core: same numpy
inputs from a seed, head dims 8, 16, 48 and 64, with and without a ragged
0/-10000 key bias. float32: the two sum in another order, so 2e-5 of the
largest output; bfloat16 (q, k, v and the probabilities rounded as the
reference rounds them): 1e-2, one bf16 rounding that may land on the
other side.

``_cuda.attention_plan`` is checked at every attention shape of the main
path, derived, not listed: the denoiser UNet and the duration predictor's
UNet of ``configs/reference_parity.json`` run on the meta device (shapes
only) with the fused ops' kernel routes recording each ``_cuda.attention``
call instead of launching it, at batch 1 and 8 and the serving buckets
(mel 400 and 800; text 128 and 601; cross-attention keys over the 267
prompt frames). In bfloat16 (tensor cores): at most 8 splits (one
cluster), none without keys as the kernel splits them, and the grid
reaching the H100's 132 SMs wherever 64-, 32- or 16-row tiles and up to 8
splits allow it, splitting no further than one block an SM; float32 keeps
the FMA kernel's 64 rows and one split.
"""
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.ops.fused_transformer import _xla_mha
from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.diffusion_encoder import DiffusionEncoder
from diff_vits_tpu_torch.models.duration import DurationPredictorUNet
from diff_vits_tpu_torch.nn import unet1d
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import fused_resnet as FR
from diff_vits_tpu_torch.ops import fused_transformer as FT

torch.set_num_threads(2)


# -- attention_plain against the JAX package's core -------------------------

@pytest.mark.parametrize("cdt,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("masked", [False, True], ids=["no_bias", "ragged"])
@pytest.mark.parametrize("d", [8, 16, 48, 64])
def test_attention_plain_matches_jax_core(d, masked, cdt, tol):
    rng = np.random.default_rng(d + 100 * masked)
    b, t, s, heads = 3, 13, 21, 2
    c = heads * d
    q = rng.normal(size=(b, t, c)).astype(np.float32)
    kv = rng.normal(size=(b, s, c)).astype(np.float32)
    perm = np.eye(c, dtype=np.float32)[rng.permutation(c)]
    bias = None
    if masked:
        keep = np.ones((b, s), np.float32)
        keep[1, s // 2:] = 0.0
        keep[2, 1:] = 0.0                    # one kept key
        bias = ((1.0 - keep) * -10000.0)[:, None, :]
    eye = np.eye(c, dtype=np.float32)
    ref = np.asarray(_xla_mha(
        jnp.asarray(q), jnp.asarray(kv), eye, eye, perm, eye,
        np.zeros(c, np.float32), None if bias is None else jnp.asarray(bias),
        heads, getattr(jnp, cdt)))
    out = FT.attention_plain(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv @ perm),
        None if bias is None else torch.from_numpy(bias), heads,
        getattr(torch, cdt)).numpy()
    assert out.shape == ref.shape == (b, t, c)
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


# -- attention_plan at every main-path shape --------------------------------

CFG = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                      / "reference_parity.json"))
BATCHES = (1, 8)
MEL_BUCKETS = (400, 800)
TEXT_BUCKETS = (128, 601)
PROMPT_FRAMES = CFG.data.max_mel_len * 2 // 3 + 1   # BatchSynthesizer's
META = torch.device("meta")
SMS = 132
KERNEL_ROUTES = {"fused_resnet_block": FR._kernels,
                 "fused_self_attention": FT._self_attention_kernels,
                 "fused_cross_attention": FT._cross_attention_kernels,
                 "fused_geglu_ff": FT._geglu_ff_kernels}


def _recording(cores):
    """Patches under which the UNets' kernel routes run on meta tensors and
    each ``_cuda.attention`` call is recorded as (B, T, S, H, D, bias)."""
    def attention(q, k, v, bias, heads):
        b, t, c = q.shape
        cores.append((b, t, k.shape[1], heads, c // heads, bias is not None))
        return torch.empty_like(q)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(_cuda, "attention", attention))
    stack.enter_context(mock.patch.object(_cuda, "gemm",
                                          lambda *a, **kw: None))
    stack.enter_context(mock.patch.object(
        _cuda, "norm_stats",
        lambda x, b, t, c, groups, eps: (torch.empty(b * groups,
                                                     device=x.device),) * 2))
    for name, route in KERNEL_ROUTES.items():
        stack.enter_context(mock.patch.object(unet1d, name, route))
    return stack


def _unet_cores():
    """{site: attention calls of one UNet call}."""
    with torch.device(META):
        den = DiffusionEncoder(CFG.diffusion_encoder, device=META).unet.eval()
        v = CFG.vits
        dp = DurationPredictorUNet(v.hidden_channels, 256,
                                   v.posterior_in_channels,
                                   device=META).enc.eval()
    d = CFG.diffusion_encoder
    out = {}
    for b in BATCHES:
        for name, unet, c_in, c_ctx, lengths in (
                ("denoiser", den, d.in_channels + d.hidden_channels,
                 d.hidden_channels, MEL_BUCKETS),
                ("dp-unet", dp, v.hidden_channels, 256, TEXT_BUCKETS)):
            for t in lengths:
                cores = []
                with _recording(cores), torch.no_grad():
                    unet(torch.empty(b, t, c_in, device=META),
                         torch.zeros(b, device=META),
                         torch.empty(b, PROMPT_FRAMES, c_ctx, device=META),
                         encoder_attention_mask=torch.ones(
                             b, PROMPT_FRAMES, device=META))
                out[f"{name}-b{b}-T{t}"] = cores
    return out


UNET_RUNS = _unet_cores()


def _shapes():
    seen = {}
    for site, cores in UNET_RUNS.items():
        for shape in cores:
            seen.setdefault(shape[:5], site)
    return [pytest.param(shape, id=f"{site}-B{shape[0]}-T{shape[1]}-"
                         f"S{shape[2]}-H{shape[3]}-d{shape[4]}")
            for shape, site in seen.items()]


def _max_splits(s):
    """The most key splits S allows: a power of two, at most 8, at most one
    per 16 keys."""
    n = 1
    while 2 * n <= min(8, -(-s // 16)):
        n *= 2
    return n


@pytest.mark.parametrize("shape", _shapes())
def test_plan_fills_the_card_with_keys_in_every_split(shape):
    b, t, s, h, d = shape

    def grid(rows, splits):
        return -(-t // rows) * h * b * splits

    plan = _cuda.attention_plan(b, t, s, h, d, torch.float32)
    assert plan == _cuda.AttentionPlan(64, 1, False)
    plan = _cuda.attention_plan(b, t, s, h, d, torch.bfloat16)
    assert plan.tensor_cores and plan.rows in (64, 32, 16)
    assert plan.splits in (1, 2, 4, 8)              # one cluster <= 8 blocks
    chunks = -(-s // 16)
    for r in range(plan.splits):                    # as csrc/attention.cu
        lo = r * chunks // plan.splits * 16
        hi = min((r + 1) * chunks // plan.splits * 16, s)
        assert hi > lo, (r, lo, hi)
    most = max(grid(rows, _max_splits(s)) for rows in (64, 32, 16))
    assert grid(plan.rows, plan.splits) >= min(SMS, most)
    # the widest tile that reaches the SMs, and no more splits than it
    # takes to give every SM a block
    wider = [rows for rows in (64, 32) if rows > plan.rows]
    assert all(grid(rows, _max_splits(s)) < SMS for rows in wider)
    if plan.splits > 1:
        assert grid(plan.rows, plan.splits // 2) < SMS


def test_derivation_walks_every_attention_call():
    """Each UNet call launched the core 32 times (the count chip_smoke.py
    holds the card to): 16 self-attention calls (S = T, no bias) and 16
    cross calls over the prompt frames with the key bias; the duration
    predictor's head dims are 8 and 16, the denoiser's 16, 32, 48, 64."""
    for site, cores in UNET_RUNS.items():
        b, t = (int(x[1:]) for x in site.split("-")[-2:])
        assert len(cores) == 32, site
        self_calls = [c for c in cores if not c[5]]
        cross = [c for c in cores if c[5]]
        assert len(self_calls) == len(cross) == 16, site
        assert all(c[2] == c[1] for c in self_calls), site
        assert all(c[2] == PROMPT_FRAMES for c in cross), site
        assert all(c[0] == b and c[3] == 8 for c in cores), site
        dims = {c[4] for c in cores}
        assert dims == ({8, 16} if site.startswith("dp-unet")
                        else {16, 32, 48, 64}), site
        assert max(c[1] for c in cores) == t, site


@pytest.mark.parametrize("args,error", [
    ((1, 8, 8, 2, 16, torch.float16), TypeError),
    ((1, 8, 8, 2, 10, torch.bfloat16), ValueError),     # head dim
    ((0, 8, 8, 2, 16, torch.bfloat16), ValueError),     # empty batch
    ((1, 8, 0, 2, 16, torch.float32), ValueError),      # no key
    ((1, 8, 8, 65536, 16, torch.bfloat16), ValueError),  # grid y
], ids=["float16", "head-dim", "empty", "no-key", "heads"])
def test_plan_refuses_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        _cuda.attention_plan(*args)


def test_plan_small_grids_split_keys_and_shrink_tiles():
    """b=1 mid block self attention (T=S=50, 8 heads of 64): 16-row tiles,
    the keys in 4 splits (the 4 16-key steps of 50 keys); b=8 level 0
    (T=S=400, 8 heads of 16): 64-row tiles and 448 blocks, no split; b=1
    level 0 cross attention (S=267): 56 tiles in 4 splits."""
    assert _cuda.attention_plan(1, 50, 50, 8, 64, torch.bfloat16) == \
        _cuda.AttentionPlan(16, 4, True)
    assert _cuda.attention_plan(8, 400, 400, 8, 16, torch.bfloat16) == \
        _cuda.AttentionPlan(64, 1, True)
    assert _cuda.attention_plan(1, 400, 267, 8, 16, torch.bfloat16) == \
        _cuda.AttentionPlan(64, 4, True)
