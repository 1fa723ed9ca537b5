#!/usr/bin/env python3
"""Where the time of the port's GEMM (diff_vits_tpu_torch/csrc/gemm.cu) goes,
on one CUDA card.

    python3 tools/torch_gemm_probe.py [--out FILE] [--same-process]
                                      [--bounds-check]

Builds copies of csrc/gemm.cu with parts of the kernel compiled out (C
macros inserted into a copy under build/gemm_probe/; the package's own
source is not touched), each into its own library, and times every copy in
its own process at the GEMM shapes of K1 (the k=3 convs, GroupNorm + SiLU
prologue) and K4 (the GEGLU and output products, LayerNorm prologue) on the
main path, plus a 3200 x 128 product at one K split and K = 128 / 512 /
2,048 (the cost of a K step). Times are the kernels' device time per
launch (torch.profiler), in microseconds. Copies:

  base         the kernel as it is
  no_prologue  A's norm / FiLM / SiLU left out (the raw values go in)
  no_aload     A's global loads left out (a constant goes in)
  no_mma       the mma.sync instructions left out
  no_bload     the weight tile's copies left out
  no_cluster   launched without a cluster, each block reading only its own
               partial tile (right only where the plan has one split)
  nothing      all five of the above left out: the loop, barriers and
               epilogue alone
  noth_noepi   nothing, and no reduction or epilogue
  noth_1step   nothing, one K step a block
  noth_bare    noth_1step without the epilogue and the cluster: the launch

Numbers from copies other than ``base`` say what each part costs, not what
a kernel without it would compute. Needs nvcc (``ops._cuda`` finds it) and
no network.

``--same-process`` runs the copies as they once failed with an
"unspecified launch failure": first ``base`` alone in its own process,
then the first eight copies, ``base`` first, loaded one after another into
one process, then all ten the same way; after each copy the process
synchronises and names the first copy whose launches fault (a fault ends
the process's CUDA context, so nothing after it is timed).

``--bounds-check`` builds every copy with ``-DDVT_BOUNDS_CHECK`` (gemm.cu's
device-side asserts on its shared-memory, cp.async and global indices)
into ``build/gemm_probe_bounds/`` instead, and prints how many assert call
sites the base copy's device code holds (``cuobjdump -sass``; the normal
build holds none). A failed check is a FAULT naming the assert's line.
Times of that build are not the kernel's.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "diff_vits_tpu_torch" / "csrc"
OUT = ROOT / "build" / "gemm_probe"
BOUNDS_OUT = ROOT / "build" / "gemm_probe_bounds"

SUBS = [
    ("  switch (p.norm * 4 + (p.film != nullptr) * 2 + (p.silu != 0)) {",
     "#ifdef NO_PROLOGUE\n  return;\n#endif\n"
     "  switch (p.norm * 4 + (p.film != nullptr) * 2 + (p.silu != 0)) {"),
    ("  asm volatile(\n      \"mma.sync",
     "#ifndef NO_MMA\n  asm volatile(\n      \"mma.sync"),
    ("\"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"r\"(b0), \"r\"(b1));\n",
     "\"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"r\"(b0), \"r\"(b1));\n"
     "#endif\n"),
    ("    raw[i] = ok ? (ABF16 ? __bfloat162float(",
     "#ifdef NO_ALOAD\n    raw[i] = ok ? 0.5f : 0.f;\n#else\n"
     "    raw[i] = ok ? (ABF16 ? __bfloat162float("),
    ("                : 0.f;\n    mask |= (unsigned)ok << i;",
     "                : 0.f;\n#endif\n    mask |= (unsigned)ok << i;"),
    ("  const long gate = (long)p.N * p.sb_n;  // offset of the gate columns\n"
     "  if (vec) {",
     "  const long gate = (long)p.N * p.sb_n;  // offset of the gate columns\n"
     "#ifdef NO_BLOAD\n  return;\n#endif\n  if (vec) {"),
    ("  cluster.sync();  // every partial tile is written and visible",
     "#ifndef NO_CLUSTER\n  cluster.sync();\n#else\n  __syncthreads();\n#endif"),
    ("  cluster.sync();  // no block leaves while another reads its tile",
     "#ifndef NO_CLUSTER\n  cluster.sync();\n#endif"),
    ("      const float* src = cluster.map_shared_rank(cs, s);",
     "#ifdef NO_CLUSTER\n      const float* src = cs;\n#else\n"
     "      const float* src = cluster.map_shared_rank(cs, s);\n#endif"),
    ("  cfg.attrs = attr;\n  cfg.numAttrs = 1;",
     "  cfg.attrs = attr;\n#ifdef NO_CLUSTER\n  cfg.numAttrs = 0;\n#else\n"
     "  cfg.numAttrs = 1;\n#endif"),
    ("  for (int e = threadIdx.x; e < rows * BN / 4; e += kThreads) {",
     "#ifdef NO_EPI\n  if (rows > BM)\n#endif\n"
     "  for (int e = threadIdx.x; e < rows * BN / 4; e += kThreads) {"),
    ("  if (s0 < s1) {\n    b_fetch<BN, GEGLU, NFAST>(p, bmat, vec, s0 * BK, n0, bs);",
     "#ifdef NO_LOOP\n  s1 = min(s1, s0 + 1);\n#endif\n"
     "  if (s0 < s1) {\n    b_fetch<BN, GEGLU, NFAST>(p, bmat, vec, s0 * BK, n0, bs);"),
]
NOTHING = ["NO_PROLOGUE", "NO_ALOAD", "NO_MMA", "NO_BLOAD"]
VARIANTS = {
    "base": [], "no_prologue": ["NO_PROLOGUE"], "no_aload": ["NO_ALOAD"],
    "no_mma": ["NO_MMA"], "no_bload": ["NO_BLOAD"],
    "no_cluster": ["NO_CLUSTER"], "nothing": NOTHING,
    "noth_noepi": NOTHING + ["NO_EPI"], "noth_1step": NOTHING + ["NO_LOOP"],
    "noth_bare": NOTHING + ["NO_LOOP", "NO_EPI", "NO_CLUSTER"],
}


def patched_source() -> str:
    s = (SRC / "gemm.cu").read_text()
    for old, new in SUBS:
        if s.count(old) != 1:
            raise SystemExit(f"gemm.cu changed; no unique anchor {old!r}")
        s = s.replace(old, new)
    return s


def build_variants(cuda, out: Path, extra=()) -> None:
    out.mkdir(parents=True, exist_ok=True)
    src = out / "gemm.cu"
    src.write_text(patched_source())
    (out / "common.cuh").write_text((SRC / "common.cuh").read_text())
    procs = {name: subprocess.Popen(
        [cuda._nvcc(), *cuda.NVCC_FLAGS, *extra,
         *[f"-D{m}" for m in macros], "-o", str(out / f"{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for name, macros in VARIANTS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")


def device_us(torch, fn, iters=20) -> float:
    """Mean device time of the GEMM kernel per call, microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "gemm" in e.name]
    return sum(us) / iters


def cases(torch, cuda, dev):
    """(name, launch, forced plan or None) at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    out = []
    for b, t, c in ((8, 400, 128), (1, 400, 128), (8, 50, 512)):
        m = b * t
        x = r(b, t, c, dt=bf)
        stats = cuda.norm_stats(x, m, 1, c, 1, 1e-5)
        w1, b1 = r(8 * c, c, dt=bf).t(), r(8 * c)
        ln = (r(c), r(c))
        g = torch.empty(b, t, 4 * c, device=dev, dtype=bf)
        out.append((f"K4 geglu M={m} N={4 * c} K={c}", lambda x=x, s=stats,
                    w=w1, bb=b1, g=g, ln=ln, m=m, t=t, c=c: cuda.gemm(
                        x, [w], [g], [bb], M=m, N=4 * c, T=t, Ci=c,
                        norm=cuda.LAYER_NORM, stats=s, norm_w=ln[0],
                        norm_b=ln[1], geglu=True), None))
        w2 = r(c, 4 * c, dt=bf).t()
        o = torch.empty(b, t, c, device=dev, dtype=bf)
        out.append((f"K4 out M={m} N={c} K={4 * c}", lambda g=g, w=w2, o=o,
                    x=x, m=m, t=t, c=c: cuda.gemm(
                        g, [w], [o], [None], M=m, N=c, T=t, Ci=4 * c, res=x),
                    None))
    for b, t, ci, co in ((8, 400, 128, 128), (1, 400, 128, 128),
                         (1, 50, 1024, 512), (8, 50, 1024, 512)):
        m = b * t
        x = r(b, t, ci, dt=bf)
        stats = cuda.norm_stats(x, b, t, ci, 8, 1e-5)
        w = r(co, ci, 3, dt=bf).permute(2, 1, 0)
        gn = (r(ci), r(ci))
        h = torch.empty(b, t, co, device=dev)
        out.append((f"K1 conv M={m} N={co} K={3 * ci}", lambda x=x, s=stats,
                    w=w, h=h, gn=gn, m=m, t=t, ci=ci, co=co: cuda.gemm(
                        x, [w], [h], [None], M=m, N=co, T=t, Ci=ci, taps=3,
                        norm=cuda.GROUP_NORM, stats=s, norm_w=gn[0],
                        norm_b=gn[1], groups=8, silu=True), None))
    for k in (128, 512, 2048):
        a = r(3200, k, dt=bf)
        w = r(128, k, dt=bf).t()
        o = torch.empty(3200, 128, device=dev, dtype=bf)
        out.append((f"one split M=3200 N=128 K={k}", lambda a=a, w=w, o=o,
                    k=k: cuda.gemm(a, [w], [o], [None], M=3200, N=128,
                                   T=3200, Ci=k), (64, 64, 1)))
    return out


def assert_sites(cuda, lib: Path):
    """Mentions of the device assert handler in ``lib``'s device code
    (``cuobjdump -elf`` and ``-sass``: its symbol and calls), or None
    without cuobjdump."""
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    text = "".join(subprocess.run([str(tool), flag, str(lib)],
                                  capture_output=True, text=True).stdout
                   for flag in ("-elf", "-sass"))
    return text.lower().count("assertfail")


def run_variants(names, out: Path) -> None:
    """Time the copies ``names`` (libraries under ``out``) one after
    another in this process; print one RESULT line per copy, or FAULT
    naming the copy whose launches failed (and stop: the CUDA context is
    gone)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from diff_vits_tpu_torch.ops import _cuda
    _cuda.build()
    plan = _cuda.gemm_plan
    for name in names:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.dvt_gemm.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dvt_gemm.restype = ctypes.c_int
        _cuda._libs["gemm.cu"] = lib
        res = {}
        try:
            for case, fn, forced in cases(torch, _cuda, torch.device("cuda")):
                if forced is not None:
                    _cuda.gemm_plan = (lambda *a, f=forced:
                                       _cuda.GemmPlan(*f, True))
                res[case] = device_us(torch, fn)
                _cuda.gemm_plan = plan
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"FAULT {name}: {str(e).splitlines()[0]}", flush=True)
            return
        print(f"RESULT {name} " + json.dumps(res), flush=True)


def _results(stdout):
    """{copy: times} of the RESULT lines, and the FAULT line or None."""
    res, fault = {}, None
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            name, body = line[7:].split(" ", 1)
            res[name] = json.loads(body)
        elif line.startswith("FAULT "):
            fault = line[6:]
    return res, fault


def same_process(lib_dir: Path) -> dict:
    """``base`` alone in a process, then the first eight copies in one
    process, then all ten in one process."""
    out = {}
    for what, names in (("base alone", ["base"]),
                        ("eight copies, one process", list(VARIANTS)[:8]),
                        ("all copies, one process", list(VARIANTS))):
        proc = subprocess.run([sys.executable, __file__, "--variants",
                               ",".join(names), str(lib_dir)],
                              capture_output=True, text=True, timeout=600)
        res, fault = _results(proc.stdout)
        # a device-side assert prints its file, line and condition on
        # stderr
        out[what] = dict(rc=proc.returncode, ran=list(res), fault=fault,
                         stderr=proc.stderr[-1500:]
                         if proc.returncode or fault else "")
        print(f"{what}: rc {proc.returncode}, copies run cleanly "
              f"{list(res)}, fault {fault}", flush=True)
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--variants":
        run_variants(sys.argv[2].split(","), Path(sys.argv[3]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the table as JSON")
    ap.add_argument("--same-process", action="store_true",
                    help="base alone, then eight and then all ten copies "
                         "in one process")
    ap.add_argument("--bounds-check", action="store_true",
                    help="build the copies with -DDVT_BOUNDS_CHECK into "
                         "build/gemm_probe_bounds/")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from diff_vits_tpu_torch.ops import _cuda
    _cuda.build()
    lib_dir = BOUNDS_OUT if args.bounds_check else OUT
    build_variants(_cuda, lib_dir,
                   ("-DDVT_BOUNDS_CHECK",) if args.bounds_check else ())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    sites = None
    if args.bounds_check:
        sites = dict(bounds_build=assert_sites(_cuda, lib_dir / "base.so"),
                     normal_build=assert_sites(
                         _cuda, _cuda.build_dir() / f"gemm-{_cuda._digest()}"
                         ".so"))
        print(f"device assert call sites: {sites}", flush=True)
    if args.same_process:
        out = same_process(lib_dir)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(dict(
                card=card, bounds_check=args.bounds_check,
                assert_sites=sites, **out), indent=1))
        return 0
    table = {}
    for name in VARIANTS:
        proc = subprocess.run([sys.executable, __file__, "--variants", name,
                               str(lib_dir)], capture_output=True, text=True,
                              timeout=300)
        res, fault = _results(proc.stdout)
        if proc.returncode or name not in res:
            print(f"{name}: rc {proc.returncode}, fault {fault}\n"
                  f"{proc.stderr[-2000:]}")
            return 1
        table[name] = res[name]
    print("device us per launch".ljust(30)
          + "".join(v[:11].rjust(12) for v in table))
    for case in table["base"]:
        print(case.ljust(30) + "".join(f"{table[v][case]:12.1f}"
                                       for v in table))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, us=table), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
