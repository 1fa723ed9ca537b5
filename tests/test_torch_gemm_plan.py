"""The split-K plan of csrc/gemm.cu (``ops._cuda.gemm_plan``) at every GEMM
shape the main path launches.

The shapes are derived, not listed: the denoiser UNet and the duration
predictor's UNet of ``configs/reference_parity.json`` run on the meta
device (shapes only, no data) with the fused ops' kernel routes recording
each ``_cuda.gemm`` call instead of launching it, at batch 1 and 8 and the
serving buckets (mel 400 and 800 for the denoiser, text 128 and 601 for
the duration predictor, whose keys are the 267 prompt frames); K5's
projections come from its kernel route at the TextEncoder's widths. For
each shape, in bfloat16 (tensor cores) and float32 (the FMA parity route):
every split keeps at least one whole 32-deep K step, a cluster holds at
most 8 blocks, and the grid reaches the H100's 132 SMs wherever the shape
allows it with 64- or 32-wide tiles and up to 8 splits, splitting no
further than three blocks an SM.
"""
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import pytest
import torch

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.diffusion_encoder import DiffusionEncoder
from diff_vits_tpu_torch.models.duration import DurationPredictorUNet
from diff_vits_tpu_torch.nn import unet1d
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import fused_resnet as FR
from diff_vits_tpu_torch.ops import fused_transformer as FT
from diff_vits_tpu_torch.ops import rel_attention as RA

torch.set_num_threads(2)

CFG = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                      / "reference_parity.json"))
BATCHES = (1, 8)
MEL_BUCKETS = (400, 800)
TEXT_BUCKETS = (128, 601)
PROMPT_FRAMES = CFG.data.max_mel_len * 2 // 3 + 1   # BatchSynthesizer's
META = torch.device("meta")
FUSED = {"fused_resnet_block": FR._kernels,
         "fused_self_attention": FT._self_attention_kernels,
         "fused_cross_attention": FT._cross_attention_kernels,
         "fused_geglu_ff": FT._geglu_ff_kernels}


def _recording(calls, gemms):
    """Patches under which the kernel routes run on meta tensors: each op's
    call is counted, each GEMM recorded as (M, N, K, problems, geglu)."""
    def gemm(a, bmats, outs, biases, *, M, N, T, Ci, taps=1, geglu=False,
             **kw):
        gemms.append((M, N, taps * Ci, len(bmats), bool(geglu)))

    def stats(x, b, t, c, groups, eps):
        return (torch.empty(b * groups, device=x.device),) * 2

    def op(name):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            if name == "fused_resnet_block" and args[10] is not None:
                calls["shortcut"] = calls.get("shortcut", 0) + 1
            return FUSED[name](*args, **kw)
        return run

    stack = ExitStack()
    stack.enter_context(mock.patch.object(_cuda, "gemm", gemm))
    stack.enter_context(mock.patch.object(_cuda, "norm_stats", stats))
    stack.enter_context(mock.patch.object(
        _cuda, "attention", lambda q, k, v, bias, heads: torch.empty_like(q)))
    stack.enter_context(mock.patch.object(
        _cuda, "fn", lambda src, name: lambda *a: 0))
    stack.enter_context(mock.patch.object(_cuda, "stream_ptr", lambda t: 0))
    for name in FUSED:
        stack.enter_context(mock.patch.object(unet1d, name, op(name)))
    return stack


def _unet_gemms():
    """{site: (calls per fused op, GEMM shapes)} of one UNet call each."""
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
                calls, gemms = {}, []
                with _recording(calls, gemms), torch.no_grad():
                    unet(torch.empty(b, t, c_in, device=META),
                         torch.zeros(b, device=META),
                         torch.empty(b, PROMPT_FRAMES, c_ctx, device=META),
                         encoder_attention_mask=torch.ones(
                             b, PROMPT_FRAMES, device=META))
                out[f"{name}-b{b}-T{t}"] = (calls, gemms)
    return out


def _rel_gemms():
    """{site: GEMM shapes} of K5 at the TextEncoder's widths."""
    c, heads = CFG.vits.hidden_channels, CFG.vits.n_heads
    out = {}
    for b in BATCHES:
        for t in TEXT_BUCKETS:
            e = torch.empty
            w = [e(c, c, device=META) for _ in range(4)]
            bias = [e(c, device=META) for _ in range(4)]
            table = e(1, 2 * 4 + 1, c // heads, device=META)
            calls, gemms = {}, []
            with _recording(calls, gemms):
                RA._kernels(e(b, t, c, device=META),
                            torch.full((b,), t, device=META), w[0], bias[0],
                            w[1], bias[1], w[2], bias[2], w[3], bias[3],
                            table, table, heads=heads, window=4,
                            compute_dtype=torch.float32)
            out[f"text-encoder-b{b}-T{t}"] = gemms
    return out


UNET_RUNS = _unet_gemms()
REL_RUNS = _rel_gemms()


def _shapes():
    seen = {}
    runs = [(site, g) for site, (_, g) in UNET_RUNS.items()]
    for site, gemms in runs + list(REL_RUNS.items()):
        for shape in gemms:
            seen.setdefault(shape, site)
    return [pytest.param(shape, id=f"{site}-M{shape[0]}-N{shape[1]}-"
                         f"K{shape[2]}-p{shape[3]}" + ("-geglu" * shape[4]))
            for shape, site in seen.items()]


def _max_splits(k):
    """The most K-splits a shape allows: a power of two, at most 8, at most
    one per whole 32-deep step."""
    s = 1
    while 2 * s <= min(8, k // 32):
        s *= 2
    return s


@pytest.mark.parametrize("shape", _shapes())
def test_plan_fills_the_card_with_whole_k_steps(shape):
    m, n, k, problems, geglu = shape
    tiles = -(-m // 64) * problems
    steps = -(-k // 32)

    def grid(bn, splits):
        return tiles * -(-n // bn) * splits
    for dtype in (torch.bfloat16, torch.float32):
        plan = _cuda.gemm_plan(m, n, k, problems, geglu, dtype)
        assert plan.tensor_cores == (dtype == torch.bfloat16)
        assert plan.bm == 64
        # float32 keeps the FMA mainloop and its one 64-wide tile
        widths = (64, 32) if plan.tensor_cores else (64,)
        assert plan.bn in widths
        assert plan.splits in (1, 2, 4, 8)       # one cluster <= 8 blocks
        for s in range(plan.splits):             # as csrc/gemm.cu splits
            lo = s * steps // plan.splits * 32
            hi = min((s + 1) * steps // plan.splits * 32, k)
            assert hi - lo >= 32 or plan.splits == 1, (dtype, s, lo, hi)
        most = max(grid(bn, _max_splits(k)) for bn in widths)
        assert grid(plan.bn, plan.splits) >= min(132, most), dtype
        # and no more splits than it takes to hold three blocks an SM
        if plan.splits > 1:
            assert grid(plan.bn, plan.splits // 2) < 3 * 132, dtype


def test_derivation_walks_every_fused_call():
    """Each UNet call went through 22 K1, 16 K2, 16 K3 and 16 K4 kernel
    routes (the counts chip_smoke.py holds the card to) and recorded their
    GEMMs: two convs per K1 and its 1x1 shortcut where Ci != Co, two per K2
    (q/k/v as three problems, Wo), three per K3, two per K4 (one GEGLU);
    K5 its two (q/k/v, Wo)."""
    for site, (calls, gemms) in UNET_RUNS.items():
        short = calls.pop("shortcut")
        assert calls == {"fused_resnet_block": 22, "fused_self_attention": 16,
                         "fused_cross_attention": 16,
                         "fused_geglu_ff": 16}, site
        calls["shortcut"] = short
        assert 0 < short < 22, site
        assert len(gemms) == 22 * 2 + short + 16 * (2 + 3 + 2), site
        assert sum(g[4] for g in gemms) == 16, site
    c = CFG.vits.hidden_channels
    for site, gemms in REL_RUNS.items():
        b, t = (int(x[1:]) for x in site.split("-")[-2:])
        assert gemms == [(b * t, c, c, 3, False), (b * t, c, c, 1, False)]


@pytest.mark.parametrize("args,error", [
    ((0, 64, 64, 1, False, torch.bfloat16), ValueError),    # empty
    ((64, 64, 64, 4, False, torch.bfloat16), ValueError),   # 4 problems
    ((64, 64, 64, 2, True, torch.bfloat16), ValueError),    # GEGLU pair x2
    ((64 * 65536, 64, 64, 1, False, torch.float32), ValueError),  # grid y
    ((64, 64, 64, 1, False, torch.float16), TypeError),
], ids=["empty", "problems", "geglu-problems", "rows", "float16"])
def test_plan_refuses_what_the_kernel_does_not_take(args, error):
    with pytest.raises(error):
        _cuda.gemm_plan(*args)
