"""Rational-quadratic spline flows (plain) and kernel K7.

Port of ``diff_vits_tpu/ops/spline.py`` (the XLA formulation and the
autodiff path: ``piecewise_rational_quadratic_transform``,
``unconstrained_rational_quadratic_spline`` with identity linear tails,
``rational_quadratic_spline``) and of the Pallas kernel that replaces the
linear-tail spline on the sampling path, ``unconstrained_rqs_pallas`` of
``diff_vits_tpu/ops/spline_pallas.py:132`` (``_kernel`` :32, pallas_call
:162).

``unconstrained_rqs`` is K7's wrapper: on a CPU tensor it runs the plain
spline in float32 (the Pallas kernel computes in float32 whatever its
inputs, spline_pallas.py:35-38); on a CUDA tensor ``csrc/spline.cu`` runs,
one group of lanes per element, or the call raises.
Output in the input's dtype, log|det| in float32.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from diff_vits_tpu_torch.ops import _cuda

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def piecewise_rational_quadratic_transform(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tails=None, tail_bound=1.0,
        min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """The bounded spline (``tails=None``) or the linear-tail one."""
    kw = dict(inverse=inverse, min_bin_width=min_bin_width,
              min_bin_height=min_bin_height, min_derivative=min_derivative)
    if tails is None:
        return rational_quadratic_spline(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, **kw)
    return unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, tails=tails, tail_bound=tail_bound, **kw)


def _searchsorted(bin_locations, inputs, eps=1e-6):
    """Index of the bin holding each input; the top edge is nudged up by
    ``eps`` so that an input on it falls in the last bin."""
    bin_locations = torch.cat([bin_locations[..., :-1],
                               bin_locations[..., -1:] + eps], dim=-1)
    return torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1


def unconstrained_rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, tails="linear",
        tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Spline on [-tail_bound, tail_bound], identity outside (log|det| 0).
    The derivatives are padded at both ends with the constant whose
    softplus is 1 - min_derivative."""
    if tails != "linear":
        raise NotImplementedError(f"{tails} tails are not implemented.")
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1),
                                     value=constant)
    clamped = torch.clamp(inputs, -tail_bound, tail_bound)
    out, logdet = rational_quadratic_spline(
        clamped, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=inverse, left=-tail_bound,
        right=tail_bound, bottom=-tail_bound, top=tail_bound,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)
    return (torch.where(inside, out, inputs),
            torch.where(inside, logdet, torch.zeros_like(logdet)))


def _edges(unnormalized, lo, hi, min_frac):
    """Bin edges [..., num_bins + 1] on [lo, hi]: softmax, floor of
    min_frac, cumulative sum; the outer edges exactly lo and hi."""
    num_bins = unnormalized.shape[-1]
    frac = torch.softmax(unnormalized, dim=-1)
    frac = min_frac + (1 - min_frac * num_bins) * frac
    cum = (hi - lo) * torch.cumsum(frac, dim=-1)[..., :-1] + lo
    lo_t = torch.full_like(cum[..., :1], lo)
    return torch.cat([lo_t, cum, torch.full_like(lo_t, hi)], dim=-1)


def rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights,
        unnormalized_derivatives, inverse=False, left=0.0, right=1.0,
        bottom=0.0, top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Monotonic rational-quadratic spline and log|det J|; the inverse by
    the quadratic root 2c / (-b - sqrt(max(b^2 - 4ac, 0)))."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths = _edges(unnormalized_widths, left, right, min_bin_width)
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)
    cumheights = _edges(unnormalized_heights, bottom, top, min_bin_height)
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    bin_idx = _searchsorted(cumheights if inverse else cumwidths, inputs)
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def take(t):
        return torch.gather(t, -1, bin_idx)[..., 0]

    in_cumwidths, in_widths = take(cumwidths), take(widths)
    in_cumheights, in_heights = take(cumheights), take(heights)
    in_delta = take(heights / widths)
    in_d, in_d1 = take(derivatives), take(derivatives[..., 1:])
    s = in_d + in_d1 - 2 * in_delta

    if inverse:
        dy = inputs - in_cumheights
        a = dy * s + in_heights * (in_delta - in_d)
        b = in_heights * in_d - dy * s
        c = -in_delta * dy
        disc = b ** 2 - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
        outputs = root * in_widths + in_cumwidths
        tom = root * (1 - root)
        denominator = in_delta + s * tom
        numerator = in_delta ** 2 * (in_d1 * root ** 2 + 2 * in_delta * tom
                                     + in_d * (1 - root) ** 2)
        logabsdet = torch.log(numerator) - 2 * torch.log(denominator)
        return outputs, -logabsdet

    theta = (inputs - in_cumwidths) / in_widths
    tom = theta * (1 - theta)
    numerator = in_heights * (in_delta * theta ** 2 + in_d * tom)
    denominator = in_delta + s * tom
    outputs = in_cumheights + numerator / denominator
    dnum = in_delta ** 2 * (in_d1 * theta ** 2 + 2 * in_delta * tom
                            + in_d * (1 - theta) ** 2)
    return outputs, torch.log(dnum) - 2 * torch.log(denominator)


def unconstrained_rqs_plain(inputs, unnormalized_widths, unnormalized_heights,
                            unnormalized_derivatives, *, inverse=False,
                            tail_bound=1.0,
                            min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                            min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                            min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch version of K7: the linear-tail spline in float32,
    outputs in the input's dtype, log|det| float32."""
    out, logdet = unconstrained_rational_quadratic_spline(
        inputs.float(), unnormalized_widths.float(),
        unnormalized_heights.float(), unnormalized_derivatives.float(),
        inverse=inverse, tail_bound=tail_bound, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return out.to(inputs.dtype), logdet


def unconstrained_rqs(inputs, unnormalized_widths, unnormalized_heights,
                      unnormalized_derivatives, *, inverse=False,
                      tail_bound=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                      min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                      min_derivative=DEFAULT_MIN_DERIVATIVE):
    """Linear-tail RQ spline, K7. ``inputs`` any shape [...]; widths and
    heights [..., num_bins], derivatives [..., num_bins - 1] (the interior
    knots). Returns (outputs like ``inputs``, log|det| float32).

    CUDA route: float32 or bfloat16 tensors on one device, the parameters'
    last dim of stride 1. Tensors whose leading dims walk with one stride
    (strided slices of one [..., 3 * num_bins - 1] projection, ``inputs`` a
    slice of a wider tensor) are taken as they are; others are copied."""
    if inputs.device.type == "cpu":
        return unconstrained_rqs_plain(
            inputs, unnormalized_widths, unnormalized_heights,
            unnormalized_derivatives, inverse=inverse, tail_bound=tail_bound,
            min_bin_width=min_bin_width, min_bin_height=min_bin_height,
            min_derivative=min_derivative)
    if inputs.device.type != "cuda":
        raise ValueError(f"unconstrained_rqs runs on cpu or cuda, not "
                         f"{inputs.device}")
    return _kernel(inputs, unnormalized_widths, unnormalized_heights,
                   unnormalized_derivatives, inverse, tail_bound,
                   min_bin_width, min_bin_height, min_derivative)


def _flat_stride(shape, strides):
    """The one stride that walks the dims ``shape`` in order as a flat
    index (dims of size 1 ignored), or None when there is none."""
    step = None
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size == 1:
            continue
        if step is None:
            step = stride
        elif stride != span:
            return None
        span = stride * size
    return 0 if step is None else step


def _rows(t: torch.Tensor, n: int, width: int, name: str, device):
    """``t`` viewed as ``n`` rows of ``width`` with unit stride along them,
    or a copy where its leading dims have no one stride; the row stride."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, inputs on {device}")
    shape = t.shape
    if shape[-1] != width or t.numel() != n * width:
        raise ValueError(f"{name} has shape {tuple(shape)}, want "
                         f"[..., {width}] over {n} elements")
    strides = t.stride()
    if width > 1 and strides[-1] != 1:
        raise ValueError(f"{name} must have unit stride along the bins")
    step = _flat_stride(shape[:-1], strides[:-1])
    if step is None:
        t = t.reshape(n, width)
        step = t.stride(0)
    return t, step


@functools.lru_cache(maxsize=16)
def _constants(tail_bound, min_w, min_h, min_d):
    """(host float array, its address) of csrc/spline.cu's constants:
    tail_bound, the three floors and the knot derivative at both ends,
    min_d + softplus of the pad constant, as the plain version computes it
    in float32."""
    pad = torch.tensor(math.log(math.exp(1 - min_d) - 1), dtype=torch.float32)
    d_edge = float(min_d + F.softplus(pad))
    arr = (ctypes.c_float * 5)(tail_bound, min_w, min_h, min_d, d_edge)
    return arr, ctypes.addressof(arr)


def _kernel(inputs, uw, uh, ud, inverse, tail_bound, min_bin_width,
            min_bin_height, min_derivative):
    """The kernel route: check every input, then launch."""
    num_bins = uw.shape[-1]
    n = inputs.numel()
    dev = inputs.device
    if not uw.dtype == uh.dtype == ud.dtype:
        raise TypeError("the spline parameters must share one dtype")
    flags = (_cuda.dtype_flag(inputs) | _cuda.dtype_flag(uw) << 1
             | int(inverse) << 2)
    shape = inputs.shape
    sx = _flat_stride(shape, inputs.stride())
    if sx is None:
        inputs = inputs.reshape(-1)
        sx = 1
    uw, sw = _rows(uw, n, num_bins, "unnormalized_widths", dev)
    uh, sh = _rows(uh, n, num_bins, "unnormalized_heights", dev)
    ud, sd = _rows(ud, n, num_bins - 1, "unnormalized_derivatives", dev)
    out = torch.empty(shape, device=dev, dtype=inputs.dtype)
    logdet = torch.empty(shape, device=dev, dtype=torch.float32)
    if n == 0:
        return out, logdet
    consts = _constants(float(tail_bound), float(min_bin_width),
                        float(min_bin_height), float(min_derivative))[1]
    _cuda.check(_cuda.fn("spline.cu", "dvt_spline")(
        inputs.data_ptr(), sx, uw.data_ptr(), sw, uh.data_ptr(), sh,
        ud.data_ptr(), sd, out.data_ptr(), logdet.data_ptr(), n, num_bins,
        flags, consts, _cuda.stream_ptr(out)),
        f"spline kernel with {num_bins} bins")
    unconstrained_rqs.launches += 1
    return out, logdet


unconstrained_rqs.launches = 0
