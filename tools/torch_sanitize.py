#!/usr/bin/env python3
"""Run the port's GEMM and attention kernels under NVIDIA's
compute-sanitizer (memcheck, then racecheck) on the card.

    python3 tools/torch_sanitize.py [--out FILE] [--tests] [--timeout S]

Builds the kernels first (nvcc is not run under the tool), then for each
tool runs this script's ``--drive`` mode under ``compute-sanitizer --tool
TOOL --error-exitcode 99``: every K1-K4 case and every attention-core case
of ``chip_smoke.py``'s kernel phase (the main path's shapes, B=8 and B=1,
float32 and bfloat16) launched once and synchronised, which covers
csrc/gemm.cu's split-K cluster reduction over distributed shared memory and
its cp.async weight tiles, and csrc/attention.cu's cp.async ring
and cluster merge. With ``--tests`` it then runs the GEMM and attention
GPU tests (``tests/test_torch_kernels_gpu.py -k "gemm or attention"``)
under memcheck too. Prints one line per run (tool, exit code, the
sanitizer's summary line, seconds) and, with ``--out``, writes the runs
and the tail of each output as JSON. Exits 0 when every run ran to its end
with no error reported, 1 otherwise, 2 when there is no compute-sanitizer,
3 when it reports that it does not support the device (then no run says
anything of the kernels).
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "compute-sanitizer"
    return str(path) if path.exists() else ""


def drive() -> int:
    """Launch every kernel-phase case of K1-K4 and the attention core
    once, synchronising after each."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n = 0
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(1234)
        for name, site, args, kw, _, _, _ in cs._kernel_cases(torch, dtype,
                                                              gen, dev):
            op, _ = cs._ops(name)
            out = op(*args, **kw)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out.float()).all()), (name, site)
            n += 1
    print(f"drive: {n} launches of the fused ops and the core", flush=True)
    return 0


def run(cmd, timeout):
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=timeout)
        rc, out = proc.returncode, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = 124
        out = ((e.stdout or b"").decode(errors="replace")
               + (e.stderr or b"").decode(errors="replace"))
    summary = [line for line in out.splitlines()
               if "ERROR SUMMARY" in line or "RACECHECK SUMMARY" in line]
    # the tool cannot attach to this card: every CUDA call of the program
    # then fails, and its errors say nothing of the kernels
    unsupported = "Device not supported" in out
    return dict(cmd=" ".join(cmd[:4]) + " ...", rc=rc,
                summary=summary[-1] if summary else None,
                device_not_supported=unsupported,
                seconds=time.perf_counter() - t0, tail=out[-4000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drive", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tests", action="store_true",
                    help="also run the GEMM and attention GPU tests under "
                    "memcheck")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds allowed each run")
    a = ap.parse_args(argv)
    if a.drive:
        return drive()
    tool = sanitizer()
    if not tool:
        print("torch_sanitize: no compute-sanitizer (PATH or CUDA_HOME/bin)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from diff_vits_tpu_torch.ops import _cuda
    _cuda.build()
    me = [sys.executable, str(Path(__file__).resolve()), "--drive"]
    runs = []
    plan = [("memcheck", me), ("racecheck", me)]
    if a.tests:
        plan.append(("memcheck", [
            sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "gpu",
            "-p", "no:cacheprovider", "tests/test_torch_kernels_gpu.py", "-k",
            "gemm or attention"]))
    for name, cmd in plan:
        r = run([tool, "--tool", name, "--error-exitcode", "99", *cmd],
                a.timeout)
        r["tool"] = name
        runs.append(r)
        print(f"{name}: rc {r['rc']} ({r['seconds']:.0f} s): {r['summary']}"
              + ("; the sanitizer does not support this device"
                 if r["device_not_supported"] else "")
              + f"\n{r['tail'][-1500:]}", flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(runs, indent=1))
    if any(r["device_not_supported"] for r in runs):
        return 3
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
