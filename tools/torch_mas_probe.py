#!/usr/bin/env python3
"""K6's column layout and serial depth on the card.

    python3 tools/torch_mas_probe.py [--out FILE]

1. csrc/mas.cu at the training shape [32, 400, 601] (chip_smoke.py's
   ragged inputs): the mean device ms over 20 warmed launches
   (torch.profiler), the path checked against ``maximum_path_plain``.
2. The cost of one row step: the kernel's device ms on 32 items that all
   keep every row (t_y = Ty, t_x = Ty) at Ty = 100, 200 and 400 and Tx =
   601, and the slope between them, which is what each row adds (one DP
   row step and one dependent read of the backtrack); the serial floor of
   the training shape is its longest item's rows times that slope.
3. Where a row's time goes: copies of csrc/mas.cu with one part compiled
   out (``VARIANTS``: 4 columns a DP lane in place of 8 (a layout, not a
   part compiled out: its path is exact), the path's zero fill, the DP
   loop, the score ring or
   its reads, the DP warps' row barrier, the ballots, the shuffles, the
   neighbour warp's value, the backtrack),
   each built with nvcc beside the port's own
   build and timed at the training shape. A copy computes a wrong path;
   only its time is read (a copy without the DP has no load warps either,
   which would wait for the DP forever). The anchors must match mas.cu:
   the probe exits naming the one that does not.
Needs one CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# variant: [(anchor in csrc/mas.cu, replacement)]
VARIANTS = {
    "cols4": [("return dvt::launch_cols<8>(", "return dvt::launch_cols<4>(")],
    "no_fill": [("for (long i = t; i < body; i += n)",
                 "for (long i = t; i < 0; i += n)")],
    "no_dp": [("for (int y = 0; y < t_y; ++y) {",
               "for (int y = 0; y < 0; ++y) {"),
              ("for (int k = 0; k < chunks + kInFlight - 1; ++k) {",
               "for (int k = 0; k < 0; ++k) {")],
    "no_ring": [("if (fixed + ring <= kMasMaxSmem)", "if (false)")],
    "no_row_barrier": [("bar_sync(1, 32 * dp_warps);  //", ";  //")],
    "no_backtrack": [("for (int y = t_y - 1; y >= 0; --y, row -= words) {",
                      "for (int y = t_y - 1; y >= t_y; --y, row -= words) {")],
    "no_ballot": [("__ballot_sync(kFull, x != 0 && (x == y || pc < pl));",
                   "(unsigned)(x != 0 && (x == y || pc < pl));")],
    "no_shuffle": [("below[c] = __shfl_sync(kFull, prev[c], (lane + 31) & 31);",
                    "below[c] = prev[c];")],
    "no_edge": [("const float left = warp > 0 ? edge[(y + 1) & 1][warp - 1] : 0.f;",
                 "const float left = 0.f;")],
    "no_ring_read": [("raw[c] = x0 + 32 * c < Tx ? ld(row, x0 + 32 * c, nc_dt) : 0.f;",
                      "raw[c] = 0.5f;")],
    "all_off": [],   # the four above and the row barrier together
    "no_fill_no_dp": [("for (long i = t; i < body; i += n)",
                       "for (long i = t; i < 0; i += n)"),
                      ("for (int y = 0; y < t_y; ++y) {",
                       "for (int y = 0; y < 0; ++y) {"),
                      ("for (int k = 0; k < chunks + kInFlight - 1; ++k) {",
                       "for (int k = 0; k < 0; ++k) {")],
}


VARIANTS["all_off"] = [p for name in ("no_ballot", "no_shuffle", "no_edge",
                                       "no_ring_read", "no_row_barrier")
                       for p in VARIANTS[name]]


def build_variants(_cuda):
    """{variant: the dvt_mas of a patched copy of csrc/mas.cu}."""
    src = (_cuda.CSRC / "mas.cu").read_text()
    out = _cuda.build_dir() / "mas_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for anchor, repl in patches:
            if anchor not in text:
                sys.exit(f"torch_mas_probe: anchor not in mas.cu: {anchor}")
            text = text.replace(anchor, repl)
        cu = out / f"mas_{name}.cu"
        cu.write_text(text)
        so = out / f"mas_{name}.so"
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"torch_mas_probe: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).dvt_mas
        fn.argtypes = list(_cuda._SIGNATURES["dvt_mas"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_mas_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from diff_vits_tpu_torch.ops import _cuda, mas
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _cuda.build()
    dev = torch.device("cuda")

    def run(nc, mask, fn=None):
        b, ty, tx = nc.shape
        path = torch.empty_like(nc)
        _cuda.check((fn or _cuda.fn("mas.cu", "dvt_mas"))(
            nc.data_ptr(), 0, mask.data_ptr(), path.data_ptr(), 0, b, ty,
            tx, _cuda.stream_ptr(nc)), "mas")
        return path

    res = dict(card=card, depth={})
    nc, mask, t_y = cs._mas_inputs(torch, torch.Generator().manual_seed(5),
                                   dev, False)
    ref = mas.maximum_path_plain(nc, mask)
    same = bool(torch.equal(run(nc, mask), ref))
    ms = cs.device_time(lambda: run(nc, mask), iters=20)
    res["kernel"] = dict(device_ms=ms, exact=same)
    print(f"training shape: {ms:.4f} device ms, path exact {same}",
          flush=True)
    b, tx = 32, 601
    for ty in (100, 200, 400):
        nc = torch.randn(b, ty, tx, device=dev) * 20.0 - 300.0
        mask = torch.zeros(b, ty, tx, device=dev)
        mask[:, :, :ty] = 1.0
        ms = cs.device_time(lambda: run(nc, mask), iters=20)
        res["depth"][ty] = ms
        print(f"all rows kept, Ty={ty}: {ms:.4f} device ms", flush=True)
    slope_us = 1e3 * (res["depth"][400] - res["depth"][100]) / 300
    res["row_us"] = slope_us
    res["serial_floor_ms"] = slope_us * int(t_y.max()) / 1e3
    print(f"each row adds {slope_us:.4f} us (DP step + backtrack read); "
          f"serial floor of the training shape ({int(t_y.max())} rows): "
          f"{res['serial_floor_ms']:.4f} ms; card {card}")
    nc, mask, _ = cs._mas_inputs(torch, torch.Generator().manual_seed(5),
                                 dev, False)
    res["variants"] = {}
    for name, fn in build_variants(_cuda).items():
        try:
            run(nc, mask, fn=fn)
            torch.cuda.synchronize()
        except RuntimeError as e:   # a copy that does not launch is reported
            res["variants"][name] = str(e)
            print(f"variant {name}: {e}", flush=True)
            continue
        ms = cs.device_time(lambda: run(nc, mask, fn=fn), iters=20)
        res["variants"][name] = ms
        print(f"variant {name}: {ms:.4f} device ms", flush=True)
    ok = res["kernel"]["exact"]
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
