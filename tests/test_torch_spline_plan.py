"""How K7 (csrc/spline.cu) is launched at every shape the main path gives
it.

Every K7 call of the variant's serving path is derived, not listed: the
stochastic duration predictor of ``configs/reference_parity.json``
(``duration_predictor="sdp"``) runs its reverse on the meta device (shapes
only) with each ``unconstrained_rqs`` call recorded instead of launched,
at batch 1 and 8 and the serving text buckets 128 and 601. At each call
the wrapper hands ``dvt_spline`` the views ConvFlow made, as they are (no
copy: their own addresses and strides), N = B x T, the bin count, the
flags and the host constants; the kernel's layout (lanes an element,
threads a block) is its own. Also the host-side constants (the knot
derivative at both ends equals the plain version's).
"""
import ctypes
import math
from pathlib import Path
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.duration import StochasticDurationPredictor
from diff_vits_tpu_torch.nn import flows
from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops import spline

torch.set_num_threads(2)

CFG = load_config(str(Path(__file__).resolve().parents[1] / "configs"
                      / "reference_parity.json"))
BATCHES = (1, 8)
TEXT_BUCKETS = (128, 601)
META = torch.device("meta")


def _k7_runs():
    """{(b, t): [(x, uw, uh, ud, kwargs) of each K7 call of one SDP
    reverse]}, meta tensors in the layout ConvFlow hands over."""
    v = CFG.vits
    sdp = StochasticDurationPredictor(v.hidden_channels, 192, 3, 0.5, 4,
                                      gin_channels=v.gin_channels,
                                      device=META).eval()
    out = {}
    for b in BATCHES:
        for t in TEXT_BUCKETS:
            calls = []

            def k7(x, uw, uh, ud, **kw):
                calls.append((x, uw, uh, ud, kw))
                return torch.empty_like(x), torch.empty(
                    x.shape, device=x.device, dtype=torch.float32)
            with mock.patch.object(flows, "unconstrained_rqs", k7), \
                    torch.no_grad():
                sdp(torch.empty(b, t, v.hidden_channels, device=META),
                    torch.ones(b, t, 1, device=META),
                    g=torch.empty(b, 1, v.gin_channels, device=META),
                    reverse=True, noise=torch.empty(b, t, 2, device=META))
            out[(b, t)] = calls
    return out


K7_RUNS = _k7_runs()


def test_derivation_walks_every_k7_call():
    """Three ConvFlow reverses an SDP reverse (chip_smoke.py's
    K7_PER_SDP_REVERSE), each an inverse at tail bound 5 over B x T
    elements of 10 bins."""
    for (b, t), calls in K7_RUNS.items():
        assert len(calls) == 3
        for x, uw, uh, ud, kw in calls:
            assert x.shape == (b, t, 1)
            assert uw.shape == uh.shape == (b, t, 1, 10)
            assert ud.shape == (b, t, 1, 9)
            assert kw == dict(inverse=True, tail_bound=5.0)


RUNS = sorted(K7_RUNS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,t", RUNS, ids=[f"b{b}-t{t}" for b, t in RUNS])
def test_launch_arguments_at_every_k7_call(b, t, dtype):
    """What the wrapper hands ``dvt_spline`` at each K7 call of one SDP
    reverse (CPU tensors in ConvFlow's layout, the entry point recorded
    instead of called): one value for each of its parameters, the views'
    own addresses and strides, N = B x T, 10 bins, the flags (bfloat16
    input and parameters, inverse) and the host constants."""
    launched = []

    def dvt_spline(*args):
        launched.append(args)
        return 0
    n = b * t
    for x, uw, uh, ud, kw in K7_RUNS[(b, t)]:
        views = [torch.empty_strided(m.shape, m.stride(), dtype=dtype)
                 for m in (x, uw, uh, ud)]
        with mock.patch.object(_cuda, "fn", lambda src, name: dvt_spline), \
                mock.patch.object(_cuda, "stream_ptr", lambda t: 0):
            out, ld = spline._kernel(
                *views, kw["inverse"], kw["tail_bound"],
                spline.DEFAULT_MIN_BIN_WIDTH, spline.DEFAULT_MIN_BIN_HEIGHT,
                spline.DEFAULT_MIN_DERIVATIVE)
        args = launched[-1]
        assert len(args) == len(_cuda._SIGNATURES["dvt_spline"])
        bf16 = int(dtype == torch.bfloat16)
        assert args[:13] == (
            views[0].data_ptr(), 2, views[1].data_ptr(), 10,
            views[2].data_ptr(), 10, views[3].data_ptr(), 29,
            out.data_ptr(), ld.data_ptr(), n, 10, bf16 | bf16 << 1 | 4)
        assert out.shape == ld.shape == x.shape
        assert out.dtype == dtype and ld.dtype == torch.float32
        consts = (ctypes.c_float * 5).from_address(args[13])
        assert list(consts)[:4] == [5.0, pytest.approx(1e-3),
                                    pytest.approx(1e-3), pytest.approx(1e-3)]
    assert len(launched) == 3


def test_main_path_views_need_no_copy():
    """x is ConvFlow's x[..., 1:] (every other element of [B, T, 2]), the
    widths and heights [B, T, 1, 10] quotients and the derivatives a
    slice of the [B, T, 1, 29] projection: each walks with one stride, so
    the wrapper hands them to the kernel as they are."""
    for (b, t), calls in K7_RUNS.items():
        for x, uw, uh, ud, _ in calls:
            n = x.numel()
            assert spline._flat_stride(x.shape, x.stride()) == (
                2 if n > 1 else 0)
            for u, width, stride in ((uw, 10, 10), (uh, 10, 10), (ud, 9, 29)):
                rows, step = spline._rows(u, n, width, "u", META)
                assert rows is u
                assert step == (stride if n > 1 else 0)


@pytest.mark.parametrize("shape,strides,want", [
    ((8, 601, 1), (1202, 2, 1), 2),
    ((8, 601), (601, 1), 1),
    ((1, 1, 1), (5, 3, 1), 0),
    ((601, 8, 1), (2, 1202, 1), None),
    ((4, 3), (3, 2), None),
    ((4, 1, 3), (3, 99, 1), 1),
])
def test_flat_stride(shape, strides, want):
    assert spline._flat_stride(shape, strides) == want


def test_rows_copies_only_what_has_no_one_stride():
    base = torch.arange(4 * 6 * 10, dtype=torch.float32).reshape(6, 4, 10)
    perm = base.transpose(0, 1)
    rows, step = spline._rows(perm, 24, 10, "u", perm.device)
    assert rows.shape == (24, 10) and step == 10
    torch.testing.assert_close(rows, perm.reshape(24, 10))
    with pytest.raises(ValueError, match="unit stride"):
        spline._rows(base.transpose(1, 2).contiguous().transpose(1, 2), 24,
                     10, "u", base.device)
    with pytest.raises(ValueError, match="shape"):
        spline._rows(base, 24, 9, "u", base.device)
    with pytest.raises(ValueError, match="is on"):
        spline._rows(base, 24, 10, "u", META)


@pytest.mark.parametrize("min_d", [1e-3, 1e-2])
def test_host_constants_match_the_plain_padding(min_d):
    """The knot derivative at both ends, computed once on the host, is the
    plain version's: min_d + softplus of the float32 pad constant."""
    arr, addr = spline._constants(5.0, 1e-3, 2e-3, min_d)
    assert addr == spline._constants(5.0, 1e-3, 2e-3, min_d)[1]
    pad = F.pad(torch.zeros(1, 1), (1, 1),
                value=math.log(math.exp(1 - min_d) - 1))
    want = (min_d + F.softplus(pad))[0, 0]
    assert torch.tensor(arr[4], dtype=torch.float32) == want
    assert list(arr)[:4] == [5.0, pytest.approx(1e-3), pytest.approx(2e-3),
                             pytest.approx(min_d)]
