#!/usr/bin/env python3
"""Cycle breakdown of the recon_filter_mb kernel's macroblock step, from
clock64() timers, on one CUDA card.

    python3 tools/clock_vp8_recon.py

Copies this checkout's ``gowebp_tpu_torch`` into
``gowebp_tpu_torch/_build/clock/`` (which ``.gitignore`` lists), adds
timers to the copy's ``ops/kernels/vp8_recon.cu`` at fixed points (each
found by its text: the tool fails when the kernel no longer has one),
builds the copy with nvcc and runs it once on the decode path's inputs
for the first image of ``natural_images(32, 1024, 1024, seed=7)`` encoded
on the card at q75 (``chip_smoke.recon_symbols``): B=1, the dependency
chain.  In the block that holds the middle pair of MB rows, the first
thread of each row's luma warp (thread 0 for the upper row, 64 for the
lower) sums, over the pair's ticks after the first (a tick is one MB step
of each row; the lower row is two MBs behind; the first tick's wait is
the pipeline's fill), the cycles of each part of its step: its own
inputs (modes, filter parameters, coefficient loads and iDCT), the wait
for the row above (thread 0 only; the lower row's is the barrier, which
also waits for the upper row's inputs) and the barrier after it, the
round of context loads, the recon, the filter, the stores, and the
barrier (which waits for the other warps of the pair) and the release.
Prints cycles per tick for each span and row, the launch's time and the
card's SM clock.  The timers change the kernel's code: its spans say
where the time goes, not what the kernel without them takes.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from clock_wavefront_search import clock_run

SPANS = {1: "own inputs: modes, parameters, coefficients, iDCT",
         2: "wait for the row above, and the barrier",
         3: "context loads (top samples, filtered rows above)",
         4: "recon (i4 diagonals or i16), top-samples store",
         5: "filter (vertical, then horizontal edges)",
         6: "stores (the MB, left columns, rows above)",
         7: "barrier (the pair's other warps) and release"}

# thread 0 (the upper row) or 64 (the lower) of the middle pair's block;
# each row's counters at 8 * sub: [ticks, span 1, ..., span 7].  Tick 0
# is not counted: its wait is the pipeline's fill (the rows above the
# pair reaching their first MBs), not a step.
T = "if ((tid & 63) == 0 && row - sub == a.mh / 2) "


def mark(span: int, indent: int) -> str:
    return (" " * indent + T + "{ const long long t = clock64(); if (tick > 0) "
            f"g_clk[8 * sub + {span}] += t - tA; tA = t; }}\n")


# (anchor text, what goes right after it)
PATCHES = [
    ('#include "wavefront_mb.cuh"\n', "\n__device__ unsigned long long g_clk[32];\n"),
    ("    int seen = 0;  // thread 0: the row above's last published count\n",
     "    long long tA = 0;\n"),
    ("    for (int tick = 0; tick < mw + 2 * (kRows - 1); tick++) {\n",
     "      " + T + "{ tA = clock64(); if (tick > 0) g_clk[8 * sub] += 1; }\n"),
    ("                         a.ftype == 1};\n        }\n      }\n", mark(1, 6)),
    ("      if (tid == 0 && act && my > 0) wait_progress(a.progress + row - 1, min(mx + 2, mw),"
     " seen);\n      __syncthreads();\n", mark(2, 6)),
    ("        if (on && ht && lane < 16) unpack4(R.wy + kr * kWY + 4 + 4 * kc, above);\n"
     "        __syncwarp();\n", mark(3, 8)),
    ("          store_row16(tsy + (size_t)row * W + x0, R.sy + 16 * kSW + 1);\n", mark(4, 8)),
    ("        filter_mb<20, kWY, kSW>(R.wy, R.sy + kSW + 1, lane, lane < 16, on, hl, ht, e);\n",
     mark(5, 8)),
    ("                      R.wy + r * kWY + 4);\n        }\n", mark(6, 8)),
    ("      if (act && sub == kRows - 1 && (tid & 63) == 0) st_release(a.progress + row,"
     " mx + 1);\n", mark(7, 6)),
]
READER = """
extern "C" int recon_filter_mb_clocks(unsigned long long* out, int reset) {
  unsigned long long z[32] = {0};
  return reset ? (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z))
               : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));
}
"""

RUN = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import torch
import chip_smoke
from gowebp_tpu_torch import encode_rgba_batch
from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
from gowebp_tpu_torch.utils.corpus import natural_images

dev = torch.device("cuda:0")
lib = kvr.LIBRARY.load()
lib.recon_filter_mb_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
files = encode_rgba_batch(list(natural_images(1, 1024, 1024, seed=7)),
                          quality=75.0, device="cuda")
coeffs, modes, fp, ftype, mw, mh = chip_smoke.recon_symbols(dev, files)
run = lambda: kvr.recon_filter_mb(coeffs, modes, fp, mw, mh, ftype)
run()
buf = (ctypes.c_ulonglong * 32)()
assert lib.recon_filter_mb_clocks(buf, 1) == 0
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record(); run(); b.record(); b.synchronize()
assert lib.recon_filter_mb_clocks(buf, 0) == 0
print(json.dumps({"ms": a.elapsed_time(b), "clk": list(buf)}))
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("clock_vp8_recon: CUDA is not available", file=sys.stderr)
        return 2
    got = clock_run("vp8_recon.cu", PATCHES, READER, RUN)
    if got is None:
        return 1
    res, card = got
    clk = res["clk"]
    print(f"B=1, one 1024x1024 image: {res['ms']:.3f} ms; "
          f"{clk[0]} ticks of the middle pair timed ({card})")
    print(f"{'cycles a tick':52s} {'upper row':>10s} {'lower row':>10s}")
    totals = [0.0, 0.0]
    for i, what in SPANS.items():
        per = [clk[8 * r + i] / clk[8 * r] for r in (0, 1)]
        totals = [t + c for t, c in zip(totals, per)]
        print(f"{what:52s} {per[0]:10.1f} {per[1]:10.1f}")
    print(f"{'the whole tick':52s} {totals[0]:10.1f} {totals[1]:10.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
