"""Build and bind the port's CUDA kernels (``diff_vits_tpu_torch/csrc``).

Each ``.cu`` source compiles with nvcc for ``sm_90a`` into its own shared
library with a plain C interface under ``build/kernels/`` of the checkout
(of an installed package: under ``$XDG_CACHE_HOME`` or ``~/.cache``),
named by a hash of the sources and flags so an edit rebuilds. All sources
build at once, one nvcc process each, at the first launch of any kernel
(or through :func:`build`). Nothing here runs at import: the CPU tests
import every module, and this machine may have no nvcc.

The C functions take tensors as raw pointers (``data_ptr()``), dtype flags
and PyTorch's current stream, launch without synchronising, and return the
launch's ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[2]
SOURCES = ("norm_stats.cu", "gemm.cu", "attention.cu", "mas.cu",
           "rel_attention.cu", "spline.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

F32, BF16 = 0, 1
_DTYPE_FLAG = {torch.float32: F32, torch.bfloat16: BF16}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "dvt_norm_stats": (_P, _I, _P, _P, _I, _I, _I, _I, _F, _P),
    "dvt_gemm": (_P, _P),
    "dvt_gemm_args_size": (),
    "dvt_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                      _P),
    "dvt_mas": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    "dvt_rel_attention": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                          _I, _F, _P),
    "dvt_rel_attention_mma": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                              _I, _F, _I, _I, _P),
    "dvt_round_kv": (_P, _P, _P, _P, _L, _P),
    "dvt_spline": (_P, _L, _P, _L, _P, _L, _P, _L, _P, _P, _L, _I, _I, _P, _P),
    "dvt_flash_forward": (_P, _P),
    "dvt_flash_backward": (_P, _P),
    "dvt_flash_args_size": (),
}


class GemmArgs(ctypes.Structure):
    """Mirror of ``dvt::GemmArgs`` in csrc/gemm.cu (field for field)."""
    _fields_ = [
        ("a", _P), ("b", _P * 3), ("out", _P * 3), ("bias", _P * 3),
        ("res", _P), ("stat_mean", _P), ("stat_rstd", _P), ("norm_w", _P),
        ("norm_b", _P), ("film", _P),
        ("M", _I), ("N", _I), ("K", _I),
        ("sb_k", _I), ("sb_n", _I),
        ("T", _I), ("Ci", _I), ("G", _I), ("taps", _I), ("tap_minor", _I),
        ("norm", _I), ("silu", _I), ("geglu", _I), ("problems", _I),
        ("a_dtype", _I), ("b_dtype", _I), ("out_dtype", _I),
        ("res_dtype", _I), ("norm_dtype", _I), ("bias_dtype", _I),
        ("bn", _I), ("splits", _I),
    ]


class View(ctypes.Structure):
    """Mirror of ``dvt::View`` in csrc/flash_attention.cu: a [B, H, L, D]
    tensor with a unit last stride."""
    _fields_ = [("p", _P), ("sb", _L), ("sh", _L), ("sl", _L)]


class FlashArgs(ctypes.Structure):
    """Mirror of ``dvt::FlashArgs`` in csrc/flash_attention.cu."""
    _fields_ = [
        ("q", View), ("k", View), ("v", View), ("o", View), ("dout", View),
        ("dq", View), ("dk", View), ("dv", View),
        ("lse", _P), ("delta", _P), ("keep", _P),
        ("B", _I), ("H", _I), ("T", _I), ("S", _I), ("D", _I), ("dt", _I),
        ("scale", _F), ("qrows", _I), ("krows", _I), ("mma", _I),
    ]


_libs: Dict[str, ctypes.CDLL] = {}
_build_log: Optional[str] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under CUDA_HOME)")
    return str(path)


def build_dir() -> Path:
    """``build/kernels`` of the checkout this package lies in; a per-user
    cache directory for an installed package."""
    if (_CHECKOUT / "pyproject.toml").is_file():
        return _CHECKOUT / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "diff_vits_tpu_torch" / "kernels"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build() -> str:
    """Compile every source (in parallel) unless already built; load them.
    Returns nvcc's output (the ``-Xptxas -v`` register/shared-memory
    summary), empty when the libraries were already there."""
    global _build_log
    if _libs:
        return _build_log or ""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    targets = {src: out_dir / f"{Path(src).stem}-{tag}.so"
               for src in SOURCES}
    procs = {}
    for src, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    logs = []
    failed = []
    for src, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== nvcc {src} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, so)
    _build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{_build_log}")
    for src, so in targets.items():
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        _libs[src] = lib
    for src, name, mirror in (("gemm.cu", "dvt_gemm_args_size", GemmArgs),
                              ("flash_attention.cu", "dvt_flash_args_size",
                               FlashArgs)):
        size = getattr(_libs[src], name)()
        if size != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__name__} layout mismatch: C {size} "
                               f"bytes, ctypes {ctypes.sizeof(mirror)}")
    return _build_log


def fn(src: str, name: str):
    """The C entry point ``name`` of ``src``, building on first use."""
    if not _libs:
        build()
    return getattr(_libs[src], name)


def check(rc: int, what: str) -> None:
    """Raise on a C entry point's return code: -1 means it refused its
    arguments, any other non-zero value is the launch's cudaError_t."""
    if rc == -1:
        raise ValueError(f"{what}: arguments refused by the kernel")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of CUDA tensor ``t``'s device, as a raw pointer
    (no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dtype_flag(t: torch.Tensor) -> int:
    try:
        return _DTYPE_FLAG[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# -- launchers shared by the fused ops (callers have checked their inputs) --

NO_NORM, LAYER_NORM, GROUP_NORM = 0, 1, 2


def norm_stats(x: torch.Tensor, b: int, t: int, c: int, groups: int,
               eps: float):
    """Mean and rstd [b * groups] float32 of ``x`` viewed as [b, t, c]."""
    mean = torch.empty(b * groups, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    check(fn("norm_stats.cu", "dvt_norm_stats")(
        x.data_ptr(), dtype_flag(x), mean.data_ptr(), rstd.data_ptr(),
        b, t, c, groups, float(eps), stream_ptr(x)), "norm_stats")
    return mean, rstd


# csrc/gemm.cu's tiles: 64 rows, 32-deep K steps; the H100's 132 SMs, each
# holding three blocks of the tensor-core kernel (~150 registers a thread;
# two of the GEGLU one)
GEMM_BM, GEMM_BK, GEMM_SMS, GEMM_MAX_SPLITS = 64, 32, 132, 8
GEMM_BLOCKS = 3 * GEMM_SMS


class GemmPlan(NamedTuple):
    """How csrc/gemm.cu runs one launch: a ``bm`` x ``bn`` output tile,
    ``splits`` K-splits (the blocks of one cluster), on tensor cores
    (bfloat16 weights) or the float32 FMA mainloop."""
    bm: int
    bn: int
    splits: int
    tensor_cores: bool


def gemm_plan(M: int, N: int, K: int, problems: int, geglu: bool,
              dtype: torch.dtype) -> GemmPlan:
    """The tile and split-K of one csrc/gemm.cu launch of ``problems``
    [M, K] x [K, N] products whose weights are ``dtype``; raises on what the
    kernel does not take.

    Enough blocks to fill the SMs where the shape allows it: a 64-wide tile
    while 64-wide tiles times the most splits reach 132 blocks, else a
    32-wide one (tensor cores only); then the fewest splits (a power of two
    up to 8, at most one per whole 32-deep K step) that reach three blocks
    an SM (396): a block's K steps wait on their loads, and its SM hides
    that only behind other blocks."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm takes float32 or bfloat16 weights, got {dtype}")
    if min(M, N, K) < 1:
        raise ValueError(f"gemm needs M, N, K >= 1, got {M}, {N}, {K}")
    if not 1 <= problems <= 3 or (geglu and problems != 1):
        raise ValueError(f"gemm takes 1-3 problems sharing A (GEGLU: 1), "
                         f"got {problems}")
    m_tiles = -(-M // GEMM_BM)
    if m_tiles > 65535 or (M + GEMM_BM) * K >= 2 ** 31:
        raise ValueError(f"gemm takes M <= {65535 * GEMM_BM} and "
                         f"(M + {GEMM_BM}) * K < 2**31, got M={M}, K={K}")
    tensor_cores = dtype == torch.bfloat16
    max_splits = 1
    while max_splits * 2 <= min(GEMM_MAX_SPLITS, K // GEMM_BK):
        max_splits *= 2

    def blocks(bn: int, splits: int) -> int:
        return m_tiles * -(-N // bn) * problems * splits

    bn = 64
    if tensor_cores and blocks(64, max_splits) < GEMM_SMS:
        bn = 32
    splits = 1
    while splits < max_splits and blocks(bn, splits) < GEMM_BLOCKS:
        splits *= 2
    return GemmPlan(GEMM_BM, bn, splits, tensor_cores)


def gemm(a: torch.Tensor, bmats, outs, biases, *, M: int, N: int, T: int,
         Ci: int, taps: int = 1, norm: int = NO_NORM, stats=None,
         norm_w=None, norm_b=None, groups: int = 1, film=None,
         silu: bool = False, geglu: bool = False,
         res: Optional[torch.Tensor] = None) -> None:
    """One launch of csrc/gemm.cu over ``len(bmats)`` problems sharing A,
    planned by :func:`gemm_plan` (which raises on what it refuses). Each
    weight is a [Ci, N'] (``taps`` 1) or [3, Ci, N'] (``taps`` 3) view,
    N' = 2N for GEGLU, whose (tap, ci) index one stride spans; all share
    their strides."""
    n = len(bmats)
    plan = gemm_plan(M, N, taps * Ci, n, geglu, bmats[0].dtype)
    tap_minor = False
    if taps == 3:
        # a k=3 conv sums over (tap, ci) in the weight's storage order
        s_tap, s_ci, sb_n = bmats[0].stride()
        tap_minor = abs(s_tap) < abs(s_ci)
        sb_k = s_tap if tap_minor else s_ci
    else:
        sb_k, sb_n = bmats[0].stride()
    args = GemmArgs()
    args.a = a.data_ptr()
    for i in range(n):
        args.b[i] = bmats[i].data_ptr()
        args.out[i] = outs[i].data_ptr()
        args.bias[i] = ptr(biases[i])
    args.res = ptr(res)
    if stats is not None:
        args.stat_mean = stats[0].data_ptr()
        args.stat_rstd = stats[1].data_ptr()
    args.norm_w, args.norm_b = ptr(norm_w), ptr(norm_b)
    args.film = ptr(film)
    args.M, args.N, args.K = M, N, taps * Ci
    args.sb_k, args.sb_n = sb_k, sb_n
    args.T, args.Ci, args.G, args.taps = T, Ci, groups, taps
    args.tap_minor = int(tap_minor)
    args.norm, args.silu, args.geglu, args.problems = norm, int(silu), \
        int(geglu), n
    args.a_dtype, args.b_dtype = dtype_flag(a), dtype_flag(bmats[0])
    args.out_dtype = dtype_flag(outs[0])
    args.res_dtype = dtype_flag(res) if res is not None else F32
    # the callers pass a norm's scale and bias, and a launch's biases, in
    # one dtype
    args.norm_dtype = dtype_flag(norm_w) if norm_w is not None else F32
    bias = next((t for t in biases if t is not None), None)
    args.bias_dtype = dtype_flag(bias) if bias is not None else F32
    args.bn, args.splits = plan.bn, plan.splits
    check(fn("gemm.cu", "dvt_gemm")(ctypes.byref(args), stream_ptr(a)),
          "gemm")


# csrc/attention.cu's tensor-core kernel: 16 query rows a warp, 1, 2 or 4
# warps a block; key splits in whole 16-key steps, at most 8 (one cluster),
# until the grid has a block for each SM
ATTN_ROWS = (64, 32, 16)
ATTN_SPLIT_KEYS, ATTN_MAX_SPLITS = 16, 8
ATTN_HEAD_DIMS = (8, 16, 32, 48, 64)
ATTN_FMA_ROWS = 64
ATTN_MIN_BLOCKS = GEMM_SMS


class AttentionPlan(NamedTuple):
    """How csrc/attention.cu runs one launch: ``rows`` queries of one
    (batch, head) a block, the keys split ``splits`` ways (the blocks of one
    cluster), on tensor cores (bfloat16) or the float32 FMA kernel."""
    rows: int
    splits: int
    tensor_cores: bool


def attention_plan(B: int, T: int, S: int, H: int, D: int,
                   dtype: torch.dtype) -> AttentionPlan:
    """The query tile and key splits of one csrc/attention.cu launch over
    q [B, T, H*D] and k, v [B, S, H*D] in ``dtype``; raises on what the
    kernel does not take.

    float32 runs the FMA kernel: 64 queries a block, no split. bfloat16:
    the widest query tile (64, 32, 16 rows) whose grid reaches the 132 SMs
    with the most splits the keys allow (a power of two up to 8, at most one
    per 16 keys, so that no split is empty), else 16 rows; then the fewest
    splits that give every SM a block (``ATTN_MIN_BLOCKS``). A block's key
    tiles are a latency chain that splits shorten, but each split adds a
    cluster merge over distributed shared memory, which cost more than it
    saved beyond one block an SM (tools/torch_attention_probe.py times the
    main path's shapes at other targets; PERF.md)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    if min(B, T, S, H) < 1:
        raise ValueError(f"attention needs B, T, S, H >= 1, got {B}, {T}, "
                         f"{S}, {H}")
    if D not in ATTN_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims 8, 16, 32, 48 "
                         f"or 64; got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"attention takes B, H <= 65535, got {B}, {H}")
    if dtype == torch.float32:
        return AttentionPlan(ATTN_FMA_ROWS, 1, False)
    return AttentionPlan(*_split_plan(B, T, S, H), True)


def _split_plan(B: int, T: int, S: int, H: int):
    """(rows, splits) of a tensor-core attention launch (csrc/attention.cu
    and csrc/rel_attention.cu): the widest query tile (64, 32, 16 rows)
    whose grid reaches the 132 SMs with the most splits the keys allow (a
    power of two up to 8, at most one per 16 keys), else 16 rows; then the
    fewest splits that give every SM a block."""
    max_splits = 1
    while max_splits * 2 <= min(ATTN_MAX_SPLITS, -(-S // ATTN_SPLIT_KEYS)):
        max_splits *= 2

    def blocks(rows: int, splits: int) -> int:
        return -(-T // rows) * H * B * splits

    rows = next((r for r in ATTN_ROWS if blocks(r, max_splits) >= GEMM_SMS),
                ATTN_ROWS[-1])
    splits = 1
    while splits < max_splits and blocks(rows, splits) < ATTN_MIN_BLOCKS:
        splits *= 2
    return rows, splits


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """csrc/attention.cu on q [B, T, H*D], k/v [B, S, H*D] (one dtype,
    contiguous, on one card), bias [B, S] float32 or None; returns o like
    q. Planned by :func:`attention_plan`, which raises on what it refuses;
    bfloat16 runs the tensor-core kernel, float32 the FMA one."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"attention takes q [B, T, C], k and v [B, S, C]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, c = q.shape
    s = k.shape[1]
    if c % heads:
        raise ValueError(f"attention: C={c} is not a multiple of {heads} "
                         f"heads")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous, in q's "
                             f"dtype and on q's device")
    if bias is not None and (bias.shape != (b, s) or bias.dtype != torch.float32
                             or bias.device != q.device
                             or not bias.is_contiguous()):
        raise ValueError(f"attention: bias must be [B, S] = {(b, s)} float32, "
                         f"contiguous, on q's device")
    plan = attention_plan(b, t, s, heads, c // heads, q.dtype)
    o = torch.empty_like(q)
    check(fn("attention.cu", "dvt_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bias), o.data_ptr(),
        b, t, s, heads, c // heads, dtype_flag(q), (c // heads) ** -0.5,
        plan.rows, plan.splits, stream_ptr(q)), "attention")
    attention.launches += 1
    return o


attention.launches = 0


# csrc/rel_attention.cu: bfloat16 on tensor cores at every head dim K5
# takes (rows and key splits by the attention core's rule), float32 on the
# FMA kernel (16 queries a block, no split); windows up to 15 (2w+1 <= 31
# band slots a row)
REL_HEAD_DIMS = (8, 16, 32, 64, 128)
REL_MAX_WINDOW = 15
REL_FMA_ROWS = 16


class RelAttentionPlan(NamedTuple):
    """How csrc/rel_attention.cu runs one launch: ``rows`` queries of one
    (batch, head) a block, the keys split ``splits`` ways (the blocks of one
    cluster), on tensor cores (bfloat16) or the float32 FMA kernel."""
    rows: int
    splits: int
    tensor_cores: bool


def rel_attention_plan(B: int, T: int, H: int, D: int,
                       dtype: torch.dtype) -> RelAttentionPlan:
    """The query tile and key splits of one csrc/rel_attention.cu launch
    over q, k, v [B, T, H*D] in compute dtype ``dtype``; raises on what the
    kernels do not take. bfloat16 follows :func:`attention_plan`'s rule
    with S = T (a query tile whose rows are all kept then splits only the
    keys up to the item's last kept one); float32 runs the FMA kernel."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rel attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if min(B, T, H) < 1:
        raise ValueError(f"rel attention needs B, T, H >= 1, got {B}, {T}, "
                         f"{H}")
    if D not in REL_HEAD_DIMS:
        raise ValueError(f"rel-attention kernel takes head dims "
                         f"{REL_HEAD_DIMS}; got {D}")
    if B > 65535 or H > 65535:
        raise ValueError(f"rel attention takes B, H <= 65535, got {B}, {H}")
    if dtype == torch.float32:
        return RelAttentionPlan(REL_FMA_ROWS, 1, False)
    return RelAttentionPlan(*_split_plan(B, T, T, H), True)


# csrc/flash_attention.cu: bfloat16 at head dims up to 64 on tensor cores
# (16 rows a warp, 1, 2 or 4 warps a block); float32, and bfloat16 above
# 64, on the FMA kernels (one row a thread, 128 a block)
FLASH_ROWS = (64, 32, 16)
FLASH_MMA_HEAD_DIMS = tuple(range(8, 65, 8))
FLASH_HEAD_DIMS = tuple(range(8, 129, 8))
FLASH_FMA_ROWS = 128


class FlashPlan(NamedTuple):
    """How csrc/flash_attention.cu runs one forward or backward: ``q_rows``
    queries of one (batch, head) a block of the forward and dQ kernels,
    ``k_rows`` keys a block of the dK/dV kernel, on tensor cores or the
    FMA kernels."""
    q_rows: int
    k_rows: int
    tensor_cores: bool


def flash_plan(B: int, T: int, S: int, H: int, D: int,
               dtype: torch.dtype) -> FlashPlan:
    """The row tiles of csrc/flash_attention.cu at q [B, H, T, D], k and v
    [B, H, S, D] in ``dtype``; raises on what the kernels do not take.

    The route is a rule of shape and dtype: bfloat16 at a head dim in
    ``FLASH_MMA_HEAD_DIMS`` runs the tensor-core kernels, float32 (the
    exact parity route) and bfloat16 above 64 the FMA kernels (128 rows a
    block), whose dK/dV kernel keeps no K, V, dK and dV fragments in
    registers. On tensor cores each side takes the widest tile (64, 32, 16
    rows) whose grid reaches the H100's 132 SMs, else 16 rows. The key
    splits of the attention core are not needed: every gated training
    site (B=32, 8 heads) has over a thousand blocks."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if min(B, T, S, H) < 1:
        raise ValueError(f"flash attention needs B, T, S, H >= 1, got {B}, "
                         f"{T}, {S}, {H}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash attention takes B, H <= 65535, got {B}, {H}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head dims that are "
                         f"multiples of 8 up to 128, got {D}")
    if dtype == torch.float32 or D not in FLASH_MMA_HEAD_DIMS:
        return FlashPlan(FLASH_FMA_ROWS, FLASH_FMA_ROWS, False)

    def rows(n: int) -> int:
        return next((r for r in FLASH_ROWS if -(-n // r) * H * B >= GEMM_SMS),
                    FLASH_ROWS[-1])
    return FlashPlan(rows(T), rows(S), True)
