#!/usr/bin/env python3
"""K7 (csrc/spline.cu) in one or more checkouts of the port, in turns on
one card, beside the launch floor.

    python3 tools/torch_spline_probe.py [DIR ...] [--rounds N] [--out FILE]

For each checkout DIR (default: this one), in turns (DIR1, DIR2, ...,
then the same in reverse, ``--rounds`` times), a child process imports
that checkout's ``diff_vits_tpu_torch``, compiles its ``csrc/spline.cu``
alone with its nvcc flags, and times ``ops.spline.unconstrained_rqs`` at
chip_smoke.py's three K7 cases (N = 4,808, 10 bins, tail bound 5: float32
inverse and forward, bfloat16 inverse; inputs made as chip_smoke.py
makes them, the same in every child): the mean device ms of a call
over 50 warmed calls by torch.profiler, the kernels' names, the
CUDA-event ms of a call (the wrapper's host work included) and the host
time of a call alone (median and least of 40 batches of 100 calls).
Each child also times the floors, by torch.profiler: an empty kernel
compiled here (the launch floor) and one that reads what K7 reads (each
element's x and its rows of widths, heights and derivatives, at the
strides K7 is handed) and writes its two outputs, with no arithmetic but
a sum over the lanes of an element, launched with the grid of the
parent's layout (38 blocks of 128 threads, one element a thread) and of
16 lanes an element in blocks of 128 (K7's) and 256. Where the
checkout's spline.cu fixes its block at ``kThreads`` threads it also
times copies of it at 32, 64 and 256 threads, whose values must equal
its own bit for bit. Prints one JSON line per child and a summary; needs
one CUDA card and nvcc.
"""
import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, BINS, TAIL = 8 * 601, 10, 5.0
CASES = (("float32", True), ("float32", False), ("bfloat16", True))
FLOOR = r"""
__global__ void empty_kernel(int) {}
// each group of G threads reads what K7 reads of one element (x, its 10
// widths and heights and 9 derivatives, rows of strides sw, sh, sd; lane k
// bins k, k + G, ...), sums it over the group by shuffles, so that no load
// is dead, and writes two outputs
template <int G>
__global__ void touch_kernel(const float* x, const float* uw, long sw,
                             const float* uh, long sh, const float* ud,
                             long sd, float* out, float* ld, long n) {
  const long e0 = ((long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int k = threadIdx.x % G;
  const bool valid = e0 < n;
  const long e = valid ? e0 : n - 1;
  float v = 0.f;
  for (int j = k; j < 10; j += G) {
    v += uw[e * sw + j] + uh[e * sh + j];
    if (j < 9) v += ud[e * sd + j];
  }
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, G);
  if (valid && k == 0) {
    out[e] = x[e] + v;
    ld[e] = v;
  }
}
extern "C" int launch_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(0);
  return (int)cudaGetLastError();
}
extern "C" int launch_touch(int blocks, int threads, int lanes,
                            const float* x, const float* uw, long sw,
                            const float* uh, long sh, const float* ud,
                            long sd, float* out, float* ld, long n,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 1)
    touch_kernel<1><<<blocks, threads, 0, s>>>(x, uw, sw, uh, sh, ud, sd,
                                               out, ld, n);
  else if (lanes == 16)
    touch_kernel<16><<<blocks, threads, 0, s>>>(x, uw, sw, uh, sh, ud, sd,
                                                out, ld, n);
  else
    return -1;
  return (int)cudaGetLastError();
}
"""
# (what, blocks, threads, lanes an element) of the floors' grids
GRIDS = (("one element a thread, 128 a block (parent)", -(-N // 128), 128, 1),
         ("16 lanes an element, 128 a block (K7)", -(-N // 8), 128, 16),
         ("16 lanes an element, 256 a block", -(-N // 16), 256, 16))


def _nvcc(_cuda, src: Path, so: Path) -> None:
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                           str(_cuda.CSRC), "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}: {proc.stdout}{proc.stderr}")


def _load_spline(_cuda, src: Path, so: Path):
    """``src`` (the checkout's csrc/spline.cu or a copy) alone, bound as
    ``_cuda.build`` binds it (the other sources are not needed here)."""
    _nvcc(_cuda, src, so)
    lib = ctypes.CDLL(str(so))
    lib.dvt_spline.argtypes = list(_cuda._SIGNATURES["dvt_spline"])
    lib.dvt_spline.restype = ctypes.c_int
    return lib


THREADS_LINE = "constexpr int kThreads = 128;"
BLOCKS = (32, 64, 256)      # threads a block of the copies


def _block_copies(_cuda, out_dir: Path) -> dict:
    """{threads: the library of a copy of spline.cu with blocks of
    ``threads``} where the checkout's spline.cu fixes kThreads, else {}."""
    text = (_cuda.CSRC / "spline.cu").read_text()
    if THREADS_LINE not in text:
        return {}
    libs = {}
    for threads in BLOCKS:
        src = out_dir / f"spline_{threads}.cu"
        src.write_text(text.replace(
            THREADS_LINE, f"constexpr int kThreads = {threads};"))
        libs[threads] = _load_spline(_cuda, src, out_dir / f"spline_"
                                     f"{threads}.so")
    return libs


def _inputs(torch, dev, dname):
    """chip_smoke.py's K7 inputs: one [N, 29] projection, widths and
    heights scaled copies, derivatives a strided slice."""
    dtype = getattr(torch, dname)
    gen = torch.Generator(device=dev).manual_seed(12)
    proj = torch.randn(N, 3 * BINS - 1, generator=gen, device=dev).to(dtype)
    uw, uh = proj[:, :BINS] / 16.0, proj[:, BINS:2 * BINS] / 16.0
    ud = proj[:, 2 * BINS:]
    x = (torch.randn(N, generator=gen, device=dev) * 3.0).to(dtype)
    return x, uw, uh, ud


def _with_lib(_cuda, lib, fn):
    """``fn()`` with ``lib`` bound as spline.cu's library."""
    own = _cuda._libs["spline.cu"]
    _cuda._libs["spline.cu"] = lib
    try:
        return fn()
    finally:
        _cuda._libs["spline.cu"] = own


def _host_us(torch, fn, batches: int = 40, calls: int = 100):
    """(median, min) microseconds of host time a call of ``fn`` over
    ``batches`` batches of ``calls`` back-to-back calls (no synchronise
    inside a batch: the card takes ~3 us a launch, the host more, so the
    queue never fills and the host clock reads the wrapper's own work)."""
    import time
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    per_call.sort()
    return per_call[len(per_call) // 2], per_call[0]


def child(checkout: Path) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    for name in [m for m in sys.modules
                 if m.startswith("diff_vits_tpu_torch")]:
        del sys.modules[name]
    from diff_vits_tpu_torch.ops import _cuda
    from diff_vits_tpu_torch.ops import spline as sp
    assert Path(sp.__file__).resolve().is_relative_to(checkout.resolve())
    out_dir = ROOT / "build" / "spline_probe" / checkout.resolve().name
    out_dir.mkdir(parents=True, exist_ok=True)
    _cuda._libs["spline.cu"] = _load_spline(
        _cuda, _cuda.CSRC / "spline.cu", out_dir / "spline.so")
    copies = _block_copies(_cuda, out_dir)
    (out_dir / "floor.cu").write_text(FLOOR)
    _nvcc(_cuda, out_dir / "floor.cu", out_dir / "floor.so")
    lib = ctypes.CDLL(str(out_dir / "floor.so"))
    _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.launch_empty.argtypes = [_I, _I, _P]
    lib.launch_touch.argtypes = [_I, _I, _I, _P, _P, _L, _P, _L, _P, _L, _P,
                                 _P, _L, _P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x, uw, uh, ud = _inputs(torch, dev, "float32")
    out, ld = torch.empty_like(x), torch.empty_like(x)
    floors = {}
    for what, blocks, threads, lanes in GRIDS:
        def touch():
            return lib.launch_touch(
                blocks, threads, lanes, x.data_ptr(), uw.data_ptr(),
                uw.stride(0), uh.data_ptr(), uh.stride(0), ud.data_ptr(),
                ud.stride(0), out.data_ptr(), ld.data_ptr(), N, stream)
        rc = (lib.launch_empty(blocks, threads, stream), touch())
        if any(rc):
            raise RuntimeError(f"floor kernels failed to launch: {rc}")
        empty = cs.device_times(
            lambda: lib.launch_empty(blocks, threads, stream), iters=50)[0]
        floors[what] = dict(blocks=blocks, threads=threads, empty_ms=empty,
                            touch_ms=cs.device_times(touch, iters=50)[0])
    rows = []
    for dname, inverse in CASES:
        x, uw, uh, ud = _inputs(torch, dev, dname)
        fn = functools.partial(sp.unconstrained_rqs, x, uw, uh, ud,
                               inverse=inverse, tail_bound=TAIL)
        out, ld = fn()
        ref, ref_ld = sp.unconstrained_rqs_plain(x, uw, uh, ud,
                                                 inverse=inverse,
                                                 tail_bound=TAIL)
        total, by_name = cs.device_times(fn, iters=50)
        host_med, host_min = _host_us(torch, fn)
        row = dict(dtype=dname, inverse=inverse, device_ms=total,
                   ms=cs.cuda_time(fn, iters=50), host_us=host_med,
                   host_min_us=host_min, kernels=sorted(by_name),
                   max_abs_err=(out.float() - ref.float()).abs().max().item(),
                   logdet_max_abs_err=(ld - ref_ld).abs().max().item())
        if copies:
            layouts = {}
            for threads, clib in copies.items():
                lfn = functools.partial(_with_lib, _cuda, clib, fn)
                lo, lld = lfn()
                if not (torch.equal(lo, out) and torch.equal(lld, ld)):
                    raise RuntimeError(f"blocks of {threads} threads change "
                                       f"the values")
                layouts[f"{threads} threads"] = dict(
                    device_ms=cs.device_times(lfn, iters=50)[0])
            row["layouts"] = layouts
        rows.append(row)
    return dict(checkout=str(checkout), card=cs.card_line(), floors=floors,
                rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child is not None:
        print("RESULT " + json.dumps(child(a.child)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_spline_probe: no CUDA device", file=sys.stderr)
        return 1
    order = []
    for _ in range(a.rounds):
        order += list(a.dirs) + list(reversed(a.dirs))
    results = []
    for d in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(d)],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        print(json.dumps(res), flush=True)
        results.append(res)
    for res in results:
        print(f"{res['checkout']} ({res['card']}):")
        for what, f in res["floors"].items():
            print(f"  floor ({what}: {f['blocks']} x {f['threads']}): "
                  f"empty kernel {f['empty_ms']:.5f} ms, K7's loads and "
                  f"stores only {f['touch_ms']:.5f} ms")
        for r in res["rows"]:
            print(f"  {r['dtype']} {'inverse' if r['inverse'] else 'forward'}"
                  f": device {r['device_ms']:.5f} ms, events {r['ms']:.5f} "
                  f"ms, host {r['host_us']:.1f} us a call (min "
                  f"{r['host_min_us']:.1f}), max |err| "
                  f"{r['max_abs_err']:.2e} / log|det| "
                  f"{r['logdet_max_abs_err']:.2e}, kernels {r['kernels']}"
                  + "".join(f"\n    blocks of {k}: device "
                            f"{v['device_ms']:.5f} ms"
                            for k, v in r.get("layouts", {}).items()))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
