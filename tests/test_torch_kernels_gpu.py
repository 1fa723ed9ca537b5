"""K1-K4 and K6 CUDA kernels on the card against their plain PyTorch
versions. K1-K4 at the ragged shapes that the main path's tile-aligned
ones do not reach:
rows and columns that fill no whole 64-wide tile, reductions shorter than
one 16-deep step, T = 1 and 2 (both conv taps at the sequence edge),
every head dim the attention kernel takes, one kept key, no key bias.
The attention core alone (csrc/attention.cu through ``_cuda.attention``,
planned by ``_cuda.attention_plan``) against ``attention_plain`` at every
head dim, T in {1, 37, 50, 400, 601}, S in {1, 70, 267, 400}, B in {1, 8}
and a key bias of none, ragged lengths, one kept key or every key at
-10000, in float32 and bfloat16 (1e-3 / 3e-2 of the largest output);
two launches with cluster key splits bit-identical; bfloat16 on
``attention_mma_kernel`` and float32 on ``attention_fma_kernel`` only;
the refusals.
Each also takes its weights in the layout the UNet modules hand over
(strided views of nn.Linear [out, in] and nn.Conv1d [out, in, k]
parameters, norm parameters and biases in the compute dtype) as well as in
the JAX layout with float32 vectors. Also the wrappers' refusals and
launch counts, a tiny UNet on the kernels against its unfused
formulation, and gradients through the kernel routes' autograd Function
(landing on the nn.Parameters, equal to plain autograd's within 1e-3).
K6 (MAS): paths identical to the plain version's (tolerance 0) on random
and tied scores, ragged lengths, Tx up to 4096 and at every edge of the
kernel's column runs, t_x = t_y and t_x = 1, the
training shape [32, 400, 601], bfloat16 scores, and a refusal of what does
not fit.
K5 (rel-pos attention): ragged lengths (kept rows compared) and no mask,
T shorter than the band, not a multiple of the 16-query or 32-key tiles,
every head dim the kernel takes, through the wrapper and through the
routed MultiHeadAttention; ragged batches whose kept query tiles stop at
the last kept key, key splits over a cluster, windows 0 and 15, an item
with no kept row (every row finite, all rows against plain); two launches
bit-identical; bfloat16 only on rel_attention_mma_kernel and float32 only
on the FMA kernel at every head dim (profiler names, route counters);
refusals, a misaligned k among them. K7 (RQ spline): forward and inverse,
inputs on the bin edges and at and beyond the tails, parameters as strided
slices of one projection, every bin instance (4, 8, 10, 16), N = 1 and
N that fills no whole block, tied parameters and repeated inputs,
ConvFlow's views taken without copies (and leading dims with no one
stride copied), the profiler name ``spline_group_kernel``. The kernel and
the plain version sum the bin
fractions in another order and contract other products into FMAs, so
their knots lie a few ulp apart, and the inverse's root moves by ulp /
(bin width x knot derivative): with unscaled N(0, 1) parameters some
inverse outputs differ by more than 1e-5, and on a knot log|det| by more
than 1e-4. So every kernel value must lie within the plain version's
values over inputs +-8 ulp (of tail_bound) from the given one (backward
error), widened by the tolerances of tests/test_spline_pallas.py (outputs
atol/rtol 1e-5, one bf16 rounding rtol 1e-2 for bfloat16 outputs;
log|det| 1e-4, 1e-3 on a knot, where at +-tail_bound the inverse's
discriminant b^2 - 4ac cancels down to (h d)^2); the forward, which is
well conditioned, is held off the knots to those tolerances directly.
K8 (flash attention): forward output and log-sum-exp against the plain
version, dq/dk/dv against autograd of it and against the backward written
out on the kernel's own output, at every head dim the kernel takes
(multiples of 8 up to 128), ragged keep masks, an item that keeps no key
and one that keeps one, one query and one key, T and S below one 16-row
warp tile and past 64-row tiles and 128-row blocks, q/k/v as heads split
off a [B, L, H*d] projection (the gradients come back in that layout), as
``chunk`` views of one [B, L, 3 H*d] projection (EncSALayer's; the
gradients come back in the same dim order) or contiguous; each launch on
the route the plan's rule gives (bfloat16 up to d = 64 on the tensor-core
kernels, float32 and wider bfloat16 on the FMA kernels: the route counters
and the profiler's kernel names); two launches bit-identical, forward and
backward; refusals, the misaligned views of the tensor-core route among
them; and the UNet's CrossAttention and the prompt encoder's EncSALayer
with ``use_flash``, which launch the forward and backward kernels once per
call and match their plain route, output and parameter gradients, in
float32 and under bfloat16 autocast; ``Trainer`` on the card with the
route on by default, for model3's configuration and the variant's.
"""
import pytest
import torch

from diff_vits_tpu_torch import ops
from diff_vits_tpu_torch.nn.fairseq import EncSALayer
from diff_vits_tpu_torch.nn.layers import MultiHeadAttention
from diff_vits_tpu_torch.nn.unet1d import (
    CrossAttention, UNet1DConditionModel, set_use_flash, set_use_fused)
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import flash_attention as FA
from diff_vits_tpu_torch.ops import fused_resnet as FR
from diff_vits_tpu_torch.ops import fused_transformer as FT
from diff_vits_tpu_torch.ops import mas
from diff_vits_tpu_torch.ops import rel_attention as RA
from diff_vits_tpu_torch.ops import spline

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def _module_layout(args, dtype):
    """The same values as the UNet modules pass them: a weight [.., in, out]
    as a view of [out, in, ..] storage, vectors in the compute dtype."""
    def conv(t):
        if t.dim() == 3:
            return t.permute(2, 1, 0).contiguous().permute(2, 1, 0)
        if t.dim() == 2:
            return t.t().contiguous().t()
        if t.dim() == 1:
            return t.to(dtype)
        return t
    return tuple(None if t is None else conv(t) for t in args)


LAYOUTS = pytest.mark.parametrize("module_layout", [False, True],
                                  ids=["jax_layout", "module_layout"])


def _assert_close(out, ref, dtype):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,ci,co,groups", [
    (3, 37, 24, 40, 8),     # 1x1 shortcut; M, N, K fill no whole tile
    (2, 37, 32, 32, 8),     # identity shortcut
    (2, 1, 16, 24, 8),      # T = 1: both conv taps outside the sequence
    (3, 2, 64, 64, 8),
    (1, 50, 1024, 512, 8),  # denoiser L3 up at b=1: split-K over a cluster
])
def test_resnet_block_kernel_matches_plain(dev, dtype, b, t, ci, co,
                                           groups, module_layout):
    gen = torch.Generator(device=dev).manual_seed(t * 31 + ci)
    r = lambda *s, **k: _rand(gen, dev, *s, **k)  # noqa: E731
    args = (r(b, t, ci, dtype=dtype), r(b, 2 * co, scale=0.3),
            1 + r(ci, scale=0.1), r(ci, scale=0.1),
            r(3, ci, co, scale=(3 * ci) ** -0.5, dtype=dtype),
            r(co, scale=0.1), 1 + r(co, scale=0.1), r(co, scale=0.1),
            r(3, co, co, scale=(3 * co) ** -0.5, dtype=dtype),
            r(co, scale=0.1))
    sc = ((r(ci, co, scale=ci ** -0.5, dtype=dtype), r(co, scale=0.1))
          if ci != co else (None, None))
    if module_layout:
        args = (args[0], args[1], *_module_layout(args[2:], dtype))
        sc = _module_layout(sc, dtype)
    kw = dict(groups=groups, eps=1e-5, compute_dtype=dtype)
    before = FR.fused_resnet_block.launches
    out = FR.fused_resnet_block(*args, *sc, **kw)
    torch.cuda.synchronize()
    assert FR.fused_resnet_block.launches == before + 1
    _assert_close(out, FR.fused_resnet_block_plain(*args, *sc, **kw), dtype)


def _attn_weights(gen, dev, c, ck, dtype):
    r = lambda *s, **k: _rand(gen, dev, *s, **k)  # noqa: E731
    return (1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, c, scale=c ** -0.5, dtype=dtype),
            r(ck, c, scale=ck ** -0.5, dtype=dtype),
            r(ck, c, scale=ck ** -0.5, dtype=dtype),
            r(c, c, scale=c ** -0.5, dtype=dtype), r(c, scale=0.1))


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,heads,d", [
    (3, 37, 8, 8), (2, 65, 8, 16), (1, 1, 4, 32), (2, 70, 8, 48),
    (3, 5, 2, 64),
])
def test_self_attention_kernel_matches_plain(dev, dtype, b, t, heads, d,
                                            module_layout):
    gen = torch.Generator(device=dev).manual_seed(t * 7 + d)
    c = heads * d
    x = _rand(gen, dev, b, t, c, dtype=dtype)
    w = _attn_weights(gen, dev, c, c, dtype)
    args = (x, *(_module_layout(w, dtype) if module_layout else w))
    before = FT.fused_self_attention.launches
    out = FT.fused_self_attention(*args, heads=heads, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert FT.fused_self_attention.launches == before + 1
    _assert_close(out, FT.fused_self_attention_plain(
        *args, heads=heads, compute_dtype=dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,s,ck,heads,d,masked", [
    (3, 37, 70, 24, 8, 8, True),    # row 2 keeps one key
    (2, 20, 1, 16, 4, 48, False),   # one key, no bias
    (2, 9, 267, 128, 8, 64, True),
])
def test_cross_attention_kernel_matches_plain(dev, dtype, b, t, s, ck, heads,
                                              d, masked):
    gen = torch.Generator(device=dev).manual_seed(s * 3 + d)
    c = heads * d
    x = _rand(gen, dev, b, t, c, dtype=dtype)
    ctx = _rand(gen, dev, b, s, ck, dtype=dtype)
    bias = None
    if masked:
        keep = torch.ones(b, s, device=dev)
        keep[1, s // 2:] = 0.0
        keep[-1, 1:] = 0.0
        bias = ((1 - keep) * -10000.0)[:, None, :].contiguous()
    ln_s, ln_b, wq, wk, wv, wo, bo = _attn_weights(gen, dev, c, ck, dtype)
    args = (x, ctx, bias, ln_s, ln_b, wq, wk, wv, wo, bo)
    before = FT.fused_cross_attention.launches
    out = FT.fused_cross_attention(*args, heads=heads, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert FT.fused_cross_attention.launches == before + 1
    _assert_close(out, FT.fused_cross_attention_plain(
        *args, heads=heads, compute_dtype=dtype), dtype)


# csrc/attention.cu alone (the core of K2 and K3), through _cuda.attention
# with the plan of _cuda.attention_plan, against attention_plain.
ATTN_T = (1, 37, 50, 400, 601)
ATTN_S = (1, 70, 267, 400)
ATTN_BIAS = ("none", "ragged", "one_key", "all_masked")
ATTN_HEADS = 4


def _core_bias(kind, b, s, dev):
    """[b, s] additive 0/-10000 key bias: none, ragged lengths (item 0
    full), one kept key, or every key at -10000."""
    if kind == "none":
        return None
    keep = torch.ones(b, s, device=dev)
    if kind == "ragged":
        for i in range(1, b):
            keep[i, max(1, s - (s * i) // b):] = 0.0
    elif kind == "one_key":
        keep[:, 1:] = 0.0
    else:
        keep.zero_()
    return ((1 - keep) * -10000.0).contiguous()


def _core_inputs(gen, dev, b, t, s, d, dtype, heads=ATTN_HEADS):
    c = heads * d
    return (_rand(gen, dev, b, t, c, dtype=dtype),
            _rand(gen, dev, b, s, c, dtype=dtype),
            _rand(gen, dev, b, s, c, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", _cuda.ATTN_HEAD_DIMS)
def test_attention_core_matches_plain(dev, dtype, d):
    """Every T x S x B x bias case at this head dim and dtype."""
    gen = torch.Generator(device=dev).manual_seed(d)
    for b in (1, 8):
        for t in ATTN_T:
            for s in ATTN_S:
                q, k, v = _core_inputs(gen, dev, b, t, s, d, dtype)
                for kind in ATTN_BIAS:
                    bias = _core_bias(kind, b, s, dev)
                    before = _cuda.attention.launches
                    out = _cuda.attention(q, k, v, bias, ATTN_HEADS)
                    torch.cuda.synchronize()
                    assert _cuda.attention.launches == before + 1
                    ref = FT.attention_plain(q, k, v, bias, ATTN_HEADS, dtype)
                    assert out.dtype == dtype and out.shape == q.shape
                    assert bool(torch.isfinite(out.float()).all()), \
                        (b, t, s, kind)
                    err = (out.float() - ref).abs().max().item()
                    assert err <= TOL[dtype] * ref.abs().max().item(), \
                        (b, t, s, kind, _cuda.attention_plan(
                            b, t, s, ATTN_HEADS, d, dtype), err)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_core_is_deterministic(dev, dtype):
    """Two launches give the same bits, key splits merged over the cluster
    included (b=1 denoiser level 0 cross attention: 4 splits)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b, t, s, heads, d = 1, 400, 267, 8, 16
    plan = _cuda.attention_plan(b, t, s, heads, d, dtype)
    assert plan.splits > 1 if dtype == torch.bfloat16 else plan.splits == 1
    q, k, v = _core_inputs(gen, dev, b, t, s, d, dtype, heads)
    bias = _core_bias("ragged", b, s, dev)
    first = _cuda.attention(q, k, v, bias, heads)
    second = _cuda.attention(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,kernel,other", [
    (torch.bfloat16, "attention_mma_kernel", "attention_fma_kernel"),
    (torch.float32, "attention_fma_kernel", "attention_mma_kernel"),
], ids=["bf16-tensor-cores", "f32-fma"])
def test_attention_core_route_by_dtype(dev, dtype, kernel, other):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = _core_inputs(gen, dev, 2, 50, 70, 32, dtype)
    _cuda.attention(q, k, v, None, ATTN_HEADS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _cuda.attention(q, k, v, None, ATTN_HEADS)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names


def test_attention_core_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    before = _cuda.attention.launches
    q, k, v = _core_inputs(gen, dev, 2, 9, 11, 10, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):      # d = 10
        _cuda.attention(q, k, v, None, ATTN_HEADS)
    q, k, v = _core_inputs(gen, dev, 2, 9, 11, 16, torch.bfloat16)
    with pytest.raises(TypeError):
        _cuda.attention(q.half(), k.half(), v.half(), None, ATTN_HEADS)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.attention(q, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                        None, ATTN_HEADS)
    with pytest.raises(ValueError, match="bias"):
        _cuda.attention(q, k, v, torch.zeros(2, 1, 11, device=dev),
                        ATTN_HEADS)
    # k one element past a 16-byte boundary: no 16-byte copy fits
    shifted = torch.empty(k.numel() + 1, device=dev,
                          dtype=k.dtype)[1:].view(k.shape).copy_(k)
    with pytest.raises(ValueError, match="refused"):
        _cuda.attention(q, shifted, v, None, ATTN_HEADS)
    torch.cuda.synchronize()
    assert _cuda.attention.launches == before


@LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,c", [(2, 130, 24), (1, 1, 8), (3, 601, 64),
                                   (1, 50, 512)])   # b=1: split-K GEGLU
def test_geglu_ff_kernel_matches_plain(dev, dtype, b, t, c, module_layout):
    gen = torch.Generator(device=dev).manual_seed(t + c)
    r = lambda *s, **k: _rand(gen, dev, *s, **k)  # noqa: E731
    args = (r(b, t, c, dtype=dtype), 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 8 * c, scale=c ** -0.5, dtype=dtype), r(8 * c, scale=0.1),
            r(4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype),
            r(c, scale=0.1))
    if module_layout:
        args = (args[0], *_module_layout(args[1:], dtype))
    before = FT.fused_geglu_ff.launches
    out = FT.fused_geglu_ff(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert FT.fused_geglu_ff.launches == before + 1
    _assert_close(out, FT.fused_geglu_ff_plain(*args, compute_dtype=dtype),
                  dtype)


def test_kernel_routes_refuse_what_they_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, c, heads = 2, 9, 40, 4          # head dim 10: no kernel
    x = _rand(gen, dev, b, t, c)
    w = _attn_weights(gen, dev, c, c, torch.float32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="head dims"):
        FT.fused_self_attention(x, *w, heads=heads,
                                compute_dtype=torch.float32)
    w = _attn_weights(gen, dev, 32, 32, torch.float32)
    x = _rand(gen, dev, b, t, 32)
    with pytest.raises(TypeError):       # weights not in compute dtype
        FT.fused_self_attention(x, *w, heads=4, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FT.fused_self_attention(x.transpose(0, 1).contiguous().transpose(
            0, 1), *w, heads=4, compute_dtype=torch.float32)
    ci = co = 16
    rargs = [_rand(gen, dev, b, t, ci), _rand(gen, dev, b, 2 * co)]
    vec = _rand(gen, dev, co)
    w_ok = _rand(gen, dev, 3, ci, co)
    w_gap = _rand(gen, dev, 3, ci + 1, co)[:, :ci]    # no one (tap, ci) stride
    with pytest.raises(ValueError, match="strides"):
        FR.fused_resnet_block(*rargs, vec, vec, w_gap, vec, vec, vec, w_ok,
                              vec, groups=8, compute_dtype=torch.float32)
    with pytest.raises(TypeError):       # float16 activations
        FT.fused_geglu_ff(x.half(), w[0], w[1], _rand(gen, dev, 32, 256),
                          _rand(gen, dev, 256), _rand(gen, dev, 128, 32),
                          w[1], compute_dtype=torch.float32)
    assert ops.launch_counts() == before


# csrc/gemm.cu alone. Its products are exact in float32 (bf16 x bf16, or
# float32 FMA), so kernel and plain version differ only in the order of
# float32 sums of up to 3,072 terms: 1e-4 of the largest output holds them.
GEMM_TOL = 1e-4


def _gemm_case(dev, m, n, k, dtype, layout, geglu=False, seed=0):
    """A [m, k] float32 activation, a [k, n'] weight (n' = 2n for GEGLU) in
    ``dtype``, as a view of [n', k] storage (the modules' k-fastest layout)
    or as it is ([k, n'], the JAX layout), a float32 bias; and the plain
    result (operands rounded to ``dtype``, float32 sums)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = 2 * n if geglu else n
    a = _rand(gen, dev, m, k)
    w = _rand(gen, dev, wide, k, scale=k ** -0.5, dtype=dtype)
    w = w.t() if layout == "module" else w.t().contiguous()
    bias = _rand(gen, dev, wide, scale=0.1)
    h = FR.mm(a, w, dtype) + bias
    ref = h[:, :n] * torch.nn.functional.gelu(h[:, n:]) if geglu else h
    return a, w, bias, ref


def _gemm_run(a, w, bias, n, geglu=False):
    out = torch.empty(a.shape[0], n, device=a.device)
    _cuda.gemm(a, [w], [out], [bias], M=a.shape[0], N=n, T=a.shape[0],
               Ci=a.shape[1], geglu=geglu)
    torch.cuda.synchronize()
    return out


GEMM_LAYOUTS = pytest.mark.parametrize("layout", ["module", "jax"])


@GEMM_LAYOUTS
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,n,k,geglu", [
    (1, 512, 3072, False),     # one row, long K: 8 splits of 32-wide tiles
    (50, 512, 3072, False),    # K1 conv1 at denoiser L3, b=1
    (50, 256, 1024, True),     # GEGLU under split-K
    (400, 128, 384, False),    # denoiser L0 conv at b=1
    (37, 40, 72, False),       # N not a multiple of 16, K of 32
    (5, 13, 20, False),        # K, N not multiples of 8: element copies
    (70, 12, 100, True),       # GEGLU, ragged N and K
])
def test_gemm_split_k_matches_plain(dev, dtype, layout, m, n, k, geglu):
    plan = _cuda.gemm_plan(m, n, k, 1, geglu, dtype)
    assert plan.tensor_cores == (dtype == torch.bfloat16)
    if k >= 1024:
        assert plan.splits > 1, plan
    a, w, bias, ref = _gemm_case(dev, m, n, k, dtype, layout, geglu)
    out = _gemm_run(a, w, bias, n, geglu)
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs().max().item()
    assert err <= GEMM_TOL * ref.abs().max().item(), (plan, err)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,n,k,geglu", [(1, 512, 3072, False),
                                         (50, 256, 1024, True)])
def test_gemm_split_k_is_deterministic(dev, dtype, m, n, k, geglu):
    """The S partials are summed in rank order over distributed shared
    memory, with no atomics: two launches give the same bits."""
    assert _cuda.gemm_plan(m, n, k, 1, geglu, dtype).splits == 8
    a, w, bias, _ = _gemm_case(dev, m, n, k, dtype, "module", geglu, seed=5)
    first = _gemm_run(a, w, bias, n, geglu)
    assert torch.equal(first, _gemm_run(a, w, bias, n, geglu))


def test_gemm_refuses_what_the_plan_refuses(dev):
    """The wrapper raises before any launch; no shape falls back to another
    route."""
    a, w, bias, _ = _gemm_case(dev, 8, 16, 64, torch.bfloat16, "module")
    out = torch.empty(8, 16, device=dev)
    with pytest.raises(ValueError, match="problems"):   # GEGLU pair x 2
        _cuda.gemm(a, [w, w], [out, out], [bias, bias], M=8, N=8, T=8,
                   Ci=64, geglu=True)
    with pytest.raises(ValueError, match="M, N, K"):
        _cuda.gemm(a[:0], [w], [out[:0]], [bias], M=0, N=16, T=1, Ci=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _cuda.gemm(a, [w.half()], [out], [bias], M=8, N=16, T=8, Ci=64)


def test_tiny_unet_on_kernels_matches_unfused(dev):
    torch.manual_seed(0)
    model = UNet1DConditionModel(8, 4, (16, 16, 32, 32),   # head dims 8, 16
                                 cross_attention_dim=16,
                                 attention_head_dim=2, device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, t, s = 3, 37, 11
    x = _rand(gen, dev, b, t, 8)
    ts = torch.tensor([999.0, 420.0, 3.0], device=dev)
    ctx = _rand(gen, dev, b, s, 16)
    keep = (torch.arange(s, device=dev)[None]
            < torch.tensor([[s], [5], [1]], device=dev)).float()
    ops.reset_launches()
    with torch.no_grad():
        out = model(x, ts, ctx, encoder_attention_mask=keep)
        torch.cuda.synchronize()
        assert ops.launch_counts() == {
            "fused_resnet_block": 22, "fused_self_attention": 16,
            "fused_cross_attention": 16, "fused_geglu_ff": 16,
            "fused_rel_self_attention": 0, "maximum_path": 0,
            "unconstrained_rqs": 0, "flash_attention_forward": 0,
            "flash_attention_backward": 0, "attention": 32}
        set_use_fused(model, False)
        ref = model(x, ts, ctx, encoder_attention_mask=keep)
    assert out.shape == (b, t, 4)
    _assert_close(out, ref, torch.float32)


def _grad_case(name, dev, dtype=torch.float32):
    """(op, plain, args, kwargs, positions of the weights) of a ragged case
    of ``name``."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    r = lambda *s, **k: _rand(gen, dev, *s, **k)  # noqa: E731
    b, t, c, ck, s = 2, 37, 32, 24, 13
    if name == "fused_resnet_block":
        ci, co = 24, 40
        args = (r(b, t, ci), r(b, 2 * co, scale=0.3), 1 + r(ci, scale=0.1),
                r(ci, scale=0.1), r(3, ci, co, scale=(3 * ci) ** -0.5),
                r(co, scale=0.1), 1 + r(co, scale=0.1), r(co, scale=0.1),
                r(3, co, co, scale=(3 * co) ** -0.5), r(co, scale=0.1),
                r(ci, co, scale=ci ** -0.5), r(co, scale=0.1))
        return FR.fused_resnet_block, FR.fused_resnet_block_plain, args, \
            dict(groups=8, eps=1e-5, compute_dtype=dtype), (4, 8, 10)
    if name == "fused_geglu_ff":
        args = (r(b, t, c), 1 + r(c, scale=0.1), r(c, scale=0.1),
                r(c, 8 * c, scale=c ** -0.5), r(8 * c, scale=0.1),
                r(4 * c, c, scale=(4 * c) ** -0.5), r(c, scale=0.1))
        return FT.fused_geglu_ff, FT.fused_geglu_ff_plain, args, \
            dict(compute_dtype=dtype), (3, 5)
    kw = dict(heads=4, compute_dtype=dtype)
    if name == "fused_self_attention":
        args = (r(b, t, c), *_attn_weights(gen, dev, c, c, dtype))
        return FT.fused_self_attention, FT.fused_self_attention_plain, \
            args, kw, (3, 4, 5, 6)
    keep = torch.ones(b, s, device=dev)
    keep[1, 5:] = 0.0
    bias = ((1 - keep) * -10000.0)[:, None, :].contiguous()
    args = (r(b, t, c), r(b, s, ck), bias,
            *_attn_weights(gen, dev, c, ck, dtype))
    return (FT.fused_cross_attention, FT.fused_cross_attention_plain, args,
            kw, (5, 6, 7, 8))


@pytest.mark.parametrize("name", ["fused_resnet_block", "fused_self_attention",
                                  "fused_cross_attention", "fused_geglu_ff"])
def test_kernel_route_gradients_reach_parameters(dev, name):
    """Weights as views of [out, in(, k)] nn.Parameters, as the UNet
    passes them: their .grad is set, and equals plain autograd's."""
    op, plain, args, kw, weights = _grad_case(name, dev)
    grads = {}
    for route, fn in (("kernel", op), ("plain", plain)):
        leaves, call = [], []
        for i, a in enumerate(args):
            if name == "fused_cross_attention" and i == 2:
                call.append(a)           # the key bias: a constant
                continue
            perm = tuple(range(a.dim()))[::-1] if i in weights else None
            leaf = torch.nn.Parameter(a if perm is None
                                      else a.permute(perm).contiguous())
            leaves.append(leaf)
            call.append(leaf if perm is None else leaf.permute(perm))
        before = op.launches
        out = fn(*call, **kw)
        assert out.grad_fn is not None
        r = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        (out * r).sum().backward()
        torch.cuda.synchronize()
        assert op.launches - before == (1 if route == "kernel" else 0)
        grads[route] = [leaf.grad for leaf in leaves]
    assert all(g is not None for g in grads["kernel"])
    for k, p in zip(grads["kernel"], grads["plain"]):
        _assert_close(k, p, torch.float32)


def test_tiny_unet_gradients_through_the_kernels(dev):
    torch.manual_seed(1)
    model = UNet1DConditionModel(8, 4, (16, 16, 32, 32),
                                 cross_attention_dim=16,
                                 attention_head_dim=2, device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(2)
    x, ctx = _rand(gen, dev, 2, 21, 8), _rand(gen, dev, 2, 9, 16)
    ts = torch.tensor([700.0, 5.0], device=dev)
    keep = (torch.arange(9, device=dev)[None]
            < torch.tensor([[9], [4]], device=dev)).float()
    grads = {}
    for route in (True, False):
        set_use_fused(model, route)
        model.zero_grad(set_to_none=True)
        ops.reset_launches()
        model(x, ts, ctx, encoder_attention_mask=keep).square().sum() \
            .backward()
        torch.cuda.synchronize()
        assert (ops.launch_counts()["fused_resnet_block"] == 22) == route
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
    set_use_fused(model, True)
    top = max(g.abs().max().item() for g in grads[False].values())
    for n, g in grads[True].items():
        assert g is not None, n
        if n.endswith("k_proj.bias"):
            # a key bias shifts every score of a query row alike, which the
            # softmax cancels: its true gradient is 0, both hold noise
            assert max(g.abs().max().item(),
                       grads[False][n].abs().max().item()) <= 1e-6 * top
            continue
        _assert_close(g, grads[False][n], torch.float32)


def _mas_case(dev, b, t_y_max, t_x_max, tied, seed):
    """Scores and mask with random lengths (item 0: t_y = Ty, item 1:
    t_x = t_y; items with t_x > t_y have an empty band and still a path
    under the reference's rules)."""
    gen = torch.Generator().manual_seed(seed)
    t_x = torch.randint(1, t_x_max + 1, (b,), generator=gen)
    t_y = torch.randint(1, t_y_max + 1, (b,), generator=gen)
    t_y[0], t_x[0] = t_y_max, min(t_x_max, t_y_max)
    if b > 1:
        t_x[1] = t_y[1] = min(t_y[1], t_x_max)
    if tied:
        neg = torch.randint(-2, 1, (b, t_y_max, t_x_max), generator=gen)
    else:
        neg = torch.randn(b, t_y_max, t_x_max, generator=gen) * 5 - 50
    mask = ((torch.arange(t_y_max)[None] < t_y[:, None])[:, :, None]
            & (torch.arange(t_x_max)[None] < t_x[:, None])[:, None, :])
    return neg.float().to(dev), mask.float().to(dev)


@pytest.mark.parametrize("b,t_y,t_x,tied", [
    (5, 37, 13, False), (4, 29, 29, True), (3, 1, 1, False),
    (2, 300, 33, True), (2, 90, 1100, True),      # 2 columns a thread
    (3, 600, 2500, False), (2, 350, 4000, True),  # 3 and 4 columns
])
def test_mas_kernel_matches_plain(dev, b, t_y, t_x, tied):
    neg, mask = _mas_case(dev, b, t_y, t_x, tied, seed=t_y + t_x)
    before = mas.maximum_path.launches
    out = mas.maximum_path(neg, mask)
    torch.cuda.synchronize()
    assert mas.maximum_path.launches == before + 1
    ref = mas.maximum_path_plain(neg, mask)
    assert out.dtype == ref.dtype == torch.float32
    assert int((out != ref).sum()) == 0


def test_mas_kernel_bfloat16_and_refusals(dev):
    neg, mask = _mas_case(dev, 4, 60, 21, False, seed=1)
    out = mas.maximum_path(neg.bfloat16(), mask)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, mas.maximum_path_plain(neg.bfloat16(), mask))
    before = mas.maximum_path.launches
    for t_y, t_x in [(8, 4097), (1800, 4000)]:   # too wide; bits too many
        z = torch.zeros(1, t_y, t_x, device=dev)
        with pytest.raises(ValueError, match="MAS kernel .* refused"):
            mas.maximum_path(z, z)
    with pytest.raises(ValueError, match="contiguous"):
        mas.maximum_path(neg.transpose(1, 2).contiguous().transpose(1, 2),
                         mask)
    assert mas.maximum_path.launches == before


@pytest.mark.parametrize("t_x", [1, 31, 32, 33, 255, 256, 257, 601, 767,
                                 768, 769, 2049, 4096])
def test_mas_kernel_column_run_boundaries(dev, t_x):
    """Tx at the edges of the DP lanes' and warps' column runs (8 columns a
    lane, 256 a warp), random and tied scores, items with t_x = t_y and
    t_x = 1."""
    for tied in (False, True):
        neg, mask = _mas_case(dev, 4, 64 if t_x < 1000 else 24, t_x, tied,
                              seed=t_x + tied)
        mask[3, :, 1:] = 0.0                          # t_x = 1
        out = mas.maximum_path(neg, mask)
        torch.cuda.synchronize()
        ref = mas.maximum_path_plain(neg, mask)
        assert int((out != ref).sum()) == 0, (t_x, tied)


def test_mas_kernel_training_shape_tied_and_random(dev):
    """[32, 400, 601] as the training step hands it over: ragged lengths,
    t_x = t_y and t_x = 1 among them; exact paths on random and tied
    scores."""
    for tied in (False, True):
        neg, mask = _mas_case(dev, 32, 400, 601, tied, seed=9 + tied)
        mask[2, :, 1:] = 0.0
        out = mas.maximum_path(neg, mask)
        torch.cuda.synchronize()
        assert torch.equal(out, mas.maximum_path_plain(neg, mask)), tied


def _rel_args(gen, dev, b, t, heads, d, dtype, window=4, co=None):
    """x, lengths (ragged, item 0 full) and the weights of one rel-pos MHA
    in the module layout (weights as views of [out, in] storage)."""
    r = lambda *s, **k: _rand(gen, dev, *s, **k)  # noqa: E731
    c = heads * d
    co = co or c
    lengths = torch.tensor([t] + [max(1, t - 7 * i) for i in range(1, b)],
                           device=dev)

    def w(cin, cout):
        return r(cout, cin, scale=cin ** -0.5, dtype=dtype).t()
    return (r(b, t, c, dtype=dtype), lengths, w(c, c), r(c, scale=0.1),
            w(c, c), r(c, scale=0.1), w(c, c), r(c, scale=0.1), w(c, co),
            r(co, scale=0.1), r(1, 2 * window + 1, d, scale=d ** -0.5),
            r(1, 2 * window + 1, d, scale=d ** -0.5))


def _assert_rows_close(out, ref, lengths, dtype):
    """Kept rows (masked rows are undefined downstream), relative to the
    largest kept |plain|."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    keep = (torch.arange(out.shape[1], device=out.device)[None]
            < lengths[:, None])
    o, p = out.float()[keep], ref.float()[keep]
    assert bool(torch.isfinite(o).all())
    err = (o - p).abs().max().item()
    assert err <= TOL[dtype] * p.abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,heads,d", [
    (3, 37, 2, 128), (2, 601, 2, 128), (2, 5, 2, 128),   # T < 2w + 1
    (3, 130, 4, 8), (2, 47, 2, 16), (1, 1, 2, 32), (2, 70, 1, 64),
])
def test_rel_attention_kernel_matches_plain(dev, dtype, b, t, heads, d):
    gen = torch.Generator(device=dev).manual_seed(t * 5 + d)
    args = _rel_args(gen, dev, b, t, heads, d, dtype)
    kw = dict(heads=heads, window=4, compute_dtype=dtype)
    for lengths in (args[1], None):
        call = (args[0], lengths, *args[2:])
        before = RA.fused_rel_self_attention.launches
        out = RA.fused_rel_self_attention(*call, **kw)
        torch.cuda.synchronize()
        assert RA.fused_rel_self_attention.launches == before + 1
        ref = RA.fused_rel_self_attention_plain(*call, **kw)
        keep = args[1] if lengths is not None else torch.full_like(args[1], t)
        _assert_rows_close(out, ref, keep, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rel_attention_module_routes_through_the_kernel(dev, dtype):
    torch.manual_seed(2)
    module = MultiHeadAttention(256, 256, 2).to(dev, dtype).eval()
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.05)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rand(gen, dev, 3, 129, 256, dtype=dtype)
    lengths = torch.tensor([129, 64, 1], device=dev)
    with torch.no_grad():
        before = RA.fused_rel_self_attention.launches
        out = module(x, lengths)
        torch.cuda.synchronize()
        assert RA.fused_rel_self_attention.launches == before + 1
        module.use_fused = False
        ref = module(x, lengths)
        assert RA.fused_rel_self_attention.launches == before + 1
    _assert_rows_close(out, ref, lengths, dtype)
    # a forward that autograd records keeps the plain route (no backward)
    module.use_fused = True
    module(x, lengths).float().sum().backward()
    assert RA.fused_rel_self_attention.launches == before + 1
    assert module.conv_q.weight.grad is not None


def test_rel_attention_kernel_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    args = _rel_args(gen, dev, 2, 9, 2, 24, torch.float32)   # head dim 24
    before = RA.fused_rel_self_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        RA.fused_rel_self_attention(*args, heads=2, window=4,
                                    compute_dtype=torch.float32)
    args = _rel_args(gen, dev, 2, 9, 2, 32, torch.float32)
    with pytest.raises(TypeError):             # weights not in bfloat16
        RA.fused_rel_self_attention(*args, heads=2, window=4,
                                    compute_dtype=torch.bfloat16)
    assert RA.fused_rel_self_attention.launches == before


REL_KERNELS = {torch.bfloat16: "rel_attention_mma_kernel<",
               torch.float32: "rel_attention_kernel<"}


def _rel_call(args, lengths, dtype, window=4, heads=2):
    return RA.fused_rel_self_attention(args[0], lengths, *args[2:],
                                       heads=heads, window=window,
                                       compute_dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t,d,window,lengths", [
    (4, 601, 128, 4, (601, 300, 70, 1)),     # tiles stop at 300 and 70
    (1, 601, 128, 4, (400,)),                # 8 key splits over 400 keys
    (3, 200, 64, 0, (200, 129, 64)),         # no band
    (2, 150, 32, 15, (150, 17)),             # the widest window
    (8, 128, 128, 4, (128, 121, 110, 96, 80, 64, 20, 0)),   # no kept row
], ids=["b4-ragged", "b1-splits", "w0", "w15", "b8-t128"])
def test_rel_attention_kernel_ragged_rows(dev, dtype, b, t, d, window,
                                          lengths):
    """Kept rows against plain (the gate); every row finite; masked rows,
    which attend uniformly, against plain too."""
    gen = torch.Generator(device=dev).manual_seed(t + d + window)
    args = _rel_args(gen, dev, b, t, 2, d, dtype, window=window)
    lengths = torch.tensor(lengths, device=dev)
    out = _rel_call(args, lengths, dtype, window)
    torch.cuda.synchronize()
    ref = RA.fused_rel_self_attention_plain(
        args[0], lengths, *args[2:], heads=2, window=window,
        compute_dtype=dtype)
    assert bool(torch.isfinite(out.float()).all())
    _assert_rows_close(out, ref, lengths, dtype)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,t", [(1, 601), (1, 128), (8, 601)])
def test_rel_attention_kernel_is_deterministic(dev, dtype, b, t):
    """Two launches give the same bits, key splits merged over the cluster
    included (b=1: 8 splits in bfloat16)."""
    gen = torch.Generator(device=dev).manual_seed(b * t)
    args = _rel_args(gen, dev, b, t, 2, 128, dtype)
    plan = _cuda.rel_attention_plan(b, t, 2, 128, dtype)
    assert plan.splits > 1 if dtype == torch.bfloat16 and b == 1 \
        else plan.splits == 1
    first = _rel_call(args, args[1], dtype)
    second = _rel_call(args, args[1], dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", RA.HEAD_DIMS)
def test_rel_attention_route_by_dtype(dev, dtype, d):
    """bfloat16 runs only rel_attention_mma_kernel, float32 only the FMA
    kernel, at every head dim (profiler names and the route counters)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(d)
    args = _rel_args(gen, dev, 2, 70, 2, d, dtype)
    _rel_call(args, args[1], dtype)
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _rel_call(args, args[1], dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    other = REL_KERNELS[torch.float32 if dtype == torch.bfloat16
                        else torch.bfloat16]
    assert any(REL_KERNELS[dtype] in n for n in names), names
    assert not any(other in n for n in names), names
    mma = int(dtype == torch.bfloat16)
    assert RA.route_counts() == {
        "fused_rel_self_attention.mma_launches": mma,
        "fused_rel_self_attention.fma_launches": 1 - mma}


def test_rel_attention_mma_refuses_misaligned_inputs(dev):
    """The tensor-core route's C entry refuses k or v off a 16-byte
    boundary (the wrapper allocates them aligned)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, c = 1, 33, 256
    q = torch.randn(b, t, c, device=dev, generator=gen)
    k = torch.randn(b, t, c, device=dev, generator=gen).bfloat16()
    shifted = torch.empty(k.numel() + 1, device=dev,
                          dtype=k.dtype)[1:].view(k.shape).copy_(k)
    e = torch.randn(9, 128, device=dev, generator=gen)
    o = torch.empty_like(k)
    plan = _cuda.rel_attention_plan(b, t, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="refused"):
        _cuda.check(_cuda.fn("rel_attention.cu", "dvt_rel_attention_mma")(
            q.data_ptr(), shifted.data_ptr(), k.data_ptr(), None,
            e.data_ptr(), e.data_ptr(), 0, o.data_ptr(), b, t, 2, 128, 4,
            0.088, plan.rows, plan.splits, _cuda.stream_ptr(q)), "rel")


def _spline_case(dev, n, num_bins, tail_bound, inverse, dtype, seed):
    """x and strided (uw, uh, ud) slices of one [n, 3 nb - 1] projection;
    a quarter of x placed on the interior bin edges (of the widths for the
    forward, the heights for the inverse), some at +-tail_bound (the outer
    knots) and some beyond it; and which x lie on a knot."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    proj = torch.randn(n, 3 * num_bins - 1, generator=gen, device=dev)
    uw, uh = proj[:, :num_bins], proj[:, num_bins:2 * num_bins]
    ud = proj[:, 2 * num_bins:]
    x = torch.randn(n, generator=gen, device=dev) * tail_bound * 0.7
    edges = spline._edges(uh if inverse else uw, -tail_bound, tail_bound,
                          1e-3)
    k = torch.randint(1, num_bins, (n,), generator=gen, device=dev)
    on_edge = torch.arange(n, device=dev) % 4 == 0
    x = torch.where(on_edge, edges.gather(1, k[:, None])[:, 0], x)
    x[1::16] = tail_bound
    x[2::16] = -tail_bound
    x[3::16] = tail_bound * 1.5
    x[5::16] = -tail_bound * 3
    on_edge[1::16] = on_edge[2::16] = True
    return x.to(dtype), uw.to(dtype), uh.to(dtype), ud.to(dtype), on_edge


def _assert_spline_close(x, uw, uh, ud, on_edge, out, ld, inverse,
                         tail_bound, dtype):
    """The kernel's (out, ld) against the plain version: off the knots
    directly (forward), and everywhere within the plain values over inputs
    +-8 ulp of tail_bound away (backward error); identity outside."""
    kw = dict(inverse=inverse, tail_bound=tail_bound)
    ref, ref_ld = spline.unconstrained_rqs_plain(x, uw, uh, ud, **kw)
    assert out.dtype == x.dtype and ld.dtype == torch.float32
    assert out.shape == x.shape and ld.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    off = ~on_edge
    if not inverse:
        torch.testing.assert_close(out.float()[off], ref.float()[off],
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(ld[off], ref_ld[off], atol=1e-4,
                                   rtol=1e-4)
    tb = torch.tensor(tail_bound)
    eps = 8 * (torch.nextafter(tb, tb + 1) - tb).item()
    env = [spline.unconstrained_rqs_plain(x.float() + s, uw.float(),
                                          uh.float(), ud.float(), **kw)
           for s in (-eps, 0.0, eps)]
    ld_tol = torch.where(on_edge, 1e-3, 1e-4)
    for got, k, t in ((out.float(), 0, tol), (ld, 1, ld_tol)):
        vals = torch.stack([e[k] for e in env])
        lo, hi = vals.min(0).values, vals.max(0).values
        assert bool(((got >= lo - t - t * lo.abs())
                     & (got <= hi + t + t * hi.abs())).all())
    outside = x.float().abs() > tail_bound
    assert torch.equal(out[outside], x[outside])
    assert not ld[outside].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n,num_bins,tail_bound", [
    (4808, 10, 5.0), (37, 10, 1.0), (1, 8, 5.0), (1000, 4, 2.0),
    (77, 16, 3.0), (300, 8, 5.0), (1, 16, 1.0), (4808, 16, 5.0),
    (4805, 10, 5.0)])
def test_spline_kernel_matches_plain(dev, dtype, inverse, n, num_bins,
                                     tail_bound):
    """Every bin instance, N = 1 and N that fills no whole block."""
    x, uw, uh, ud, on_edge = _spline_case(dev, n, num_bins, tail_bound,
                                          inverse, dtype, seed=n + num_bins)
    kw = dict(inverse=inverse, tail_bound=tail_bound)
    before = spline.unconstrained_rqs.launches
    out, ld = spline.unconstrained_rqs(x, uw, uh, ud, **kw)
    torch.cuda.synchronize()
    assert spline.unconstrained_rqs.launches == before + 1
    _assert_spline_close(x, uw, uh, ud, on_edge, out, ld, inverse,
                         tail_bound, dtype)
    outside = x.float().abs() > tail_bound
    assert outside.any() or n < 16


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("num_bins", [4, 10, 16])
def test_spline_kernel_tied_parameters_and_inputs(dev, dtype, inverse,
                                                  num_bins):
    """Tied bins (every unnormalised width, height and derivative equal:
    uniform edges, equal knot derivatives) in half the rows, the inputs
    repeated: each value on every edge, the tails, beyond them and between
    edges, for rows of tied and of random parameters alike."""
    tb = 3.0
    edges = torch.linspace(-tb, tb, num_bins + 1, device=dev)
    between = (edges[1:] + edges[:-1]) / 2
    vals = torch.cat([edges, between, torch.tensor([-4 * tb, 1.5 * tb],
                                                   device=dev)])
    reps = 9
    x = vals.repeat(reps)
    n = x.numel()
    gen = torch.Generator(device=dev).manual_seed(num_bins)
    proj = torch.randn(n, 3 * num_bins - 1, generator=gen, device=dev)
    proj[: n // 2] = 0.5
    uw, uh = proj[:, :num_bins], proj[:, num_bins:2 * num_bins]
    ud = proj[:, 2 * num_bins:]
    on_edge = torch.zeros(n, dtype=torch.bool, device=dev)
    on_edge[: n // 2] = torch.isin(x[: n // 2], edges)
    x, uw, uh, ud = (t.to(dtype) for t in (x, uw, uh, ud))
    out, ld = spline.unconstrained_rqs(x, uw, uh, ud, inverse=inverse,
                                       tail_bound=tb)
    torch.cuda.synchronize()
    _assert_spline_close(x, uw, uh, ud, on_edge, out, ld, inverse, tb, dtype)
    # a tied row maps each uniform edge onto itself
    tied_edges = torch.isin(x[: n // 2].float(), edges)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out[: n // 2][tied_edges].float(),
                               x[: n // 2][tied_edges].float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_spline_kernel_takes_convflow_views_without_copies(dev, dtype):
    """The layout ConvFlow hands over (x a slice of [B, T, 2], widths and
    heights [B, T, 1, nb] quotients, derivatives a strided slice of the
    [B, T, 1, 3 nb - 1] projection) equals the same values made
    contiguous, bit for bit; leading dims with no one stride (a permuted
    batch) are copied first and give the same values too."""
    b, t, nb = 3, 50, 10
    gen = torch.Generator(device=dev).manual_seed(5)
    z = (torch.randn(b, t, 2, generator=gen, device=dev) * 3).to(dtype)
    h = torch.randn(b, t, 1, 3 * nb - 1, generator=gen, device=dev).to(dtype)
    x1 = z[..., 1:]
    uw, uh, ud = h[..., :nb] / 4.0, h[..., nb:2 * nb] / 4.0, h[..., 2 * nb:]
    assert not x1.is_contiguous() and not ud.is_contiguous()
    kw = dict(inverse=True, tail_bound=5.0)
    out, ld = spline.unconstrained_rqs(x1, uw, uh, ud, **kw)
    ref = spline.unconstrained_rqs(*(a.contiguous() for a in (x1, uw, uh,
                                                              ud)), **kw)
    assert out.shape == ld.shape == (b, t, 1)
    assert torch.equal(out, ref[0]) and torch.equal(ld, ref[1])
    perm = [a.transpose(0, 1) for a in (x1, uw, uh, ud)]
    p_out, p_ld = spline.unconstrained_rqs(*perm, **kw)
    assert torch.equal(p_out, out.transpose(0, 1))
    assert torch.equal(p_ld, ld.transpose(0, 1))
    plain = spline.unconstrained_rqs_plain(x1, uw, uh, ud, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), plain[0].float(), atol=tol,
                               rtol=tol)


def test_spline_kernel_runs_the_group_kernel(dev):
    """Each launch is one spline_group_kernel<nb> (profiler name)."""
    from torch.profiler import ProfilerActivity, profile
    x, uw, uh, ud, _ = _spline_case(dev, 4808, 10, 5.0, True, torch.float32,
                                    1)
    spline.unconstrained_rqs(x, uw, uh, ud, inverse=True, tail_bound=5.0)
    torch.cuda.synchronize()
    # the profiler now and then records no device activity in a window
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                spline.unconstrained_rqs(x, uw, uh, ud, inverse=True,
                                         tail_bound=5.0)
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if "spline" in e.key}
        if counts:
            break
    assert counts and all("spline_group_kernel<10>" in k for k in counts)
    assert sum(counts.values()) == 3


def test_spline_kernel_refuses_what_it_does_not_take(dev):
    x, uw, uh, ud, _ = _spline_case(dev, 64, 10, 5.0, True, torch.float32,
                                    0)
    before = spline.unconstrained_rqs.launches
    with pytest.raises(ValueError, match="spline kernel .* refused"):
        spline.unconstrained_rqs(x, uw[:, :7].contiguous(),
                                 uh[:, :7].contiguous(), ud[:, :6],
                                 inverse=True, tail_bound=5.0)   # 7 bins
    with pytest.raises(ValueError, match="unit stride"):
        spline.unconstrained_rqs(x, uw.t().contiguous().t(), uh, ud,
                                 inverse=True, tail_bound=5.0)
    with pytest.raises(TypeError):
        spline.unconstrained_rqs(x, uw, uh.bfloat16(), ud, inverse=True,
                                 tail_bound=5.0)
    assert spline.unconstrained_rqs.launches == before


# -- K8: flash attention --------------------------------------------------

def _flash_case(gen, dev, b, h, t, s, d, dtype, ragged, split):
    """q [B, H, T, d], k and v [B, H, S, d]: heads split off [B, L, H*d]
    projections (``split``), ``chunk`` views of one [B, L, 3 H*d]
    projection as EncSALayer makes them (``split="chunk"``, T == S) or
    contiguous; a ragged keep mask [B, S] (item 0 all keys, the last one
    key; with ``ragged="none_kept"`` item 1 keeps no key) or None."""
    def make(n):
        if split:
            return _rand(gen, dev, b, n, h * d, dtype=dtype).unflatten(
                -1, (h, d)).transpose(1, 2)
        return _rand(gen, dev, b, h, n, d, dtype=dtype)
    keep = None
    if ragged:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lengths[0], lengths[-1] = s, 1
        keep = torch.arange(s, device=dev)[None] < lengths[:, None]
        if ragged == "none_kept":
            keep[1] = False
    if split == "chunk":
        assert t == s
        qkv = _rand(gen, dev, b, t, 3 * h * d, dtype=dtype).chunk(3, dim=-1)
        return (*(x.unflatten(-1, (h, d)).transpose(1, 2) for x in qkv),
                keep)
    return make(t), make(s), make(s), keep


def _flash_route(dtype, d):
    return "mma" if dtype == torch.bfloat16 and d in FA.MMA_HEAD_DIMS \
        else "fma"


def _check_flash(dev, dtype, b, h, t, s, d, ragged, split):
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + t + s + d)
    q, k, v, keep = _flash_case(gen, dev, b, h, t, s, d, dtype, ragged,
                                split)
    scale = d ** -0.5
    ops.reset_launches()
    o, lse = FA.flash_attention_forward(q, k, v, keep, scale)
    do = _rand(gen, dev, *o.shape, dtype=dtype)
    grads = FA.flash_attention_backward(q, k, v, o, lse, do, keep, scale)
    torch.cuda.synchronize()
    route = _flash_route(dtype, d)
    other = "fma" if route == "mma" else "mma"
    wide = int(dtype == torch.bfloat16 and route == "fma")
    counts = FA.route_counts()
    for name in ("flash_attention_forward", "flash_attention_backward"):
        assert getattr(FA, name).launches == 1
        assert counts[f"{name}.{route}_launches"] == 1
        assert counts[f"{name}.{other}_launches"] == 0
        assert counts[f"{name}.wide_bf16_launches"] == wide
    ref_o, ref_lse = FA.sdpa_plain(q, k, v, keep, sm_scale=scale,
                                   with_lse=True)
    _assert_close(o, ref_o, dtype)
    _assert_close(lse, ref_lse, dtype)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(FA.sdpa_plain(*leaves, keep, sm_scale=scale),
                               leaves, do)
    manual = FA.sdpa_backward_plain(q, k, v, o, lse, do, keep,
                                    sm_scale=scale)
    for g, ga, gm, x in zip(grads, auto, manual, (q, k, v)):
        # the input's layout: its strides where it is dense, else the
        # dense strides of its dim order (a chunk view's gaps dropped)
        assert g.stride() == torch.empty_like(x).stride()
        if split != "chunk":
            assert g.stride() == x.stride()
        _assert_close(g, ga, dtype)
        _assert_close(g, gm, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_attention_kernel_every_head_dim(dev, dtype, d):
    _check_flash(dev, dtype, 3, 2, 37, 29, d, ragged=True, split=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,h,t,s,d,ragged,split", [
    (2, 3, 1, 2, 8, False, False),        # one query, two keys
    (2, 2, 129, 130, 16, True, True),     # past a 128-row block, 64-row tile
    (2, 8, 300, 5, 32, True, False),
    (3, 2, 70, 257, 128, True, True),     # 32-row tiles at d = 128
    (2, 8, 601, 400, 8, True, True),      # the DP UNet's cross attention
    (3, 2, 7, 11, 24, True, True),        # T, S below one 16-row warp tile
    (4, 2, 65, 63, 40, "none_kept", True),    # an item keeping no key
    (3, 4, 90, 90, 56, "none_kept", "chunk"),  # EncSALayer's chunk views
    (2, 8, 400, 400, 32, True, "chunk"),  # the prompt encoder's o_proj
    (2, 1, 17, 600, 64, "none_kept", False),  # many key tiles, few queries
])
def test_flash_attention_kernel_ragged_shapes(dev, dtype, b, h, t, s, d,
                                              ragged, split):
    _check_flash(dev, dtype, b, h, t, s, d, ragged, split)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d,ragged", [(8, False), (16, True), (32, True),
                                      (72, True)])
def test_flash_attention_kernel_is_deterministic(dev, dtype, d, ragged):
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v, keep = _flash_case(gen, dev, 4, 8, 601, 400, d, dtype, ragged,
                                True)
    do = _rand(gen, dev, *q.shape, dtype=dtype)
    runs = []
    for _ in range(2):
        o, lse = FA.flash_attention_forward(q, k, v, keep, 0.3)
        runs.append((o, lse, *FA.flash_attention_backward(
            q, k, v, o, lse, do, keep, 0.3)))
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,d,kernels,others", [
    (torch.bfloat16, 16, ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                          "flash_bwd_dkdv_mma_kernel"),
     ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")),
    (torch.float32, 16, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                         "flash_bwd_dkdv_kernel"),
     ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
      "flash_bwd_dkdv_mma_kernel")),
    (torch.bfloat16, 96, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                          "flash_bwd_dkdv_kernel"),
     ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
      "flash_bwd_dkdv_mma_kernel")),
], ids=["bf16", "fp32", "bf16_wide"])
def test_flash_attention_route_by_dtype_and_head_dim(dev, dtype, d, kernels,
                                                     others):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, keep = _flash_case(gen, dev, 2, 2, 130, 70, d, dtype, True, True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    FA.sdpa(*leaves, keep, sm_scale=0.25, use_flash=True).sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        FA.sdpa(*leaves, keep, sm_scale=0.25, use_flash=True).sum().backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for kernel in kernels:
        assert any(kernel + "<" in n for n in names), (kernel, names)
    for kernel in others:
        assert not any(kernel + "<" in n for n in names), (kernel, names)


def test_flash_attention_kernel_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    before = ops.launch_counts()
    q, k, v, keep = _flash_case(gen, dev, 2, 2, 9, 7, 12, torch.float32,
                                True, True)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_forward(q, k, v, keep, 0.3)
    q, k, v, keep = _flash_case(gen, dev, 2, 2, 9, 7, 16, torch.float32,
                                True, False)
    with pytest.raises(TypeError):                 # mixed dtypes
        FA.flash_attention_forward(q, k.bfloat16(), v, keep, 0.25)
    with pytest.raises(TypeError):                 # float16
        FA.flash_attention_forward(q.half(), k.half(), v.half(), keep, 0.25)
    with pytest.raises(ValueError, match="unit last stride"):
        FA.flash_attention_forward(q.transpose(2, 3).contiguous()
                                   .transpose(2, 3), k, v, keep, 0.25)
    with pytest.raises(ValueError, match="keep"):
        FA.flash_attention_forward(q, k, v, keep[:, :-1], 0.25)
    # the tensor-core route: a start 2 bytes past 16, a row stride of 20
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, device=dev, dtype=torch.bfloat16)
    shifted = shifted[1:].view(qb.shape).copy_(qb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_forward(shifted, kb, vb, keep, 0.25)
    wide = torch.zeros(2, 2, 7, 20, device=dev, dtype=torch.bfloat16)
    wide = wide[..., :16].copy_(kb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_forward(qb, wide, vb, keep, 0.25)
    # the FMA kernels read element by element: a float32 start 4 bytes
    # past 16 and a row stride of 20 are theirs
    q32 = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape).copy_(q)
    k32 = torch.zeros(2, 2, 7, 20, device=dev)[..., :16].copy_(k)
    FA.flash_attention_forward(q32, k32, v, keep, 0.25)
    after = ops.launch_counts()
    assert after["flash_attention_forward"] == \
        before["flash_attention_forward"] + 1
    assert after["flash_attention_backward"] == \
        before["flash_attention_backward"]


def _route_outputs(module, args, autocast):
    """(output, parameter gradients) of sum(out * r) through ``module``."""
    module.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
        out = module(*args)
    r = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device).manual_seed(1))
    (out.float() * r).sum().backward()
    torch.cuda.synchronize()
    return out.float(), [p.grad.float() for p in module.parameters()]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("which", ["cross_attention", "enc_sa_layer"])
def test_flash_route_through_the_modules(dev, dtype, which, monkeypatch):
    torch.manual_seed(3)
    gen = torch.Generator(device=dev).manual_seed(4)
    b = 3
    if which == "cross_attention":
        t, s = 260, 270
        module = CrossAttention(16, 2, 8, cross_attention_dim=12).to(dev)
        keep = torch.arange(s, device=dev)[None] < torch.tensor(
            [[s], [37], [1]], device=dev)
        bias = ((~keep).float() * -10000.0)[:, None, :]
        args = (_rand(gen, dev, b, t, 16), _rand(gen, dev, b, s, 12), bias)
    else:
        t, s = 256, 256
        module = EncSALayer(64, 8, 9).to(dev)
        keep = (torch.arange(t, device=dev)[None] < torch.tensor(
            [[t], [101], [1]], device=dev)).float()[..., None]
        args = (_rand(gen, dev, b, t, 64), keep)
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.2)
    autocast = dtype == torch.bfloat16
    set_use_flash(module, True)
    before = ops.launch_counts()
    out, grads = _route_outputs(module, args, autocast)
    after = ops.launch_counts()
    assert after["flash_attention_forward"] == \
        before["flash_attention_forward"] + 1
    assert after["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1
    if autocast:
        # the same route with K8's plain version on the same bfloat16 q, k,
        # v: the module's own plain route rounds its scores to bfloat16,
        # and the layer's other bfloat16 roundings move its gradients by
        # several percent of their scale on either route
        monkeypatch.setattr(FA.FlashSDPA, "apply",
                            lambda q, k, v, keep, scale: FA.sdpa_plain(
                                q, k, v, keep, sm_scale=scale))
    else:
        set_use_flash(module, False)
    ref, ref_grads = _route_outputs(module, args, autocast)
    assert ops.launch_counts() == after
    _assert_close(out, ref, dtype)
    for g, gr in zip(grads, ref_grads):
        _assert_close(g, gr, dtype)


def test_trainer_turns_the_flash_route_on_on_the_card(dev):
    # one rule for every configuration: model3's and the sdp + flow variant
    import dataclasses
    from pathlib import Path
    from diff_vits_tpu_torch.core.config import load_config
    from diff_vits_tpu_torch.train.trainer import Trainer
    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                          / "reference_parity.json"))
    variant = dataclasses.replace(cfg, vits=dataclasses.replace(
        cfg.vits, duration_predictor="sdp", use_flow=True))
    for c in (cfg, variant):
        trainer = Trainer(c, [], device=dev)
        flags = [m.use_flash for m in trainer.model.modules()
                 if hasattr(m, "use_flash")]
        assert flags and all(flags)
        set_use_flash(trainer.model, False)
        assert not any(m.use_flash for m in trainer.model.modules()
                       if hasattr(m, "use_flash"))
