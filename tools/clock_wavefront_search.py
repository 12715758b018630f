#!/usr/bin/env python3
"""Cycle breakdown of the wavefront_search kernel's macroblock step, from
clock64() timers, on one CUDA card.

    python3 tools/clock_wavefront_search.py

Copies this checkout's ``gowebp_tpu_torch`` into
``gowebp_tpu_torch/_build/clock/`` (which ``.gitignore`` lists), adds
timers to the copy's ``ops/kernels/wavefront_search.cu`` at fixed points
(each found by its text: the tool fails when the kernel no longer has
one), builds the copy with nvcc and runs it once on the first image of
the exact engine's chunk inputs (``chip_smoke.chunk_inputs``, q75): B=1,
the dependency chain.  Thread 0 of block 0 sums, over the MBs of its row,
the cycles from the MB's start to the end of the row-above wait, to the
i16 code's end, across each of the 10 walk diagonals, to the adoption and
the recon's barrier, the hand-over and the output stores; thread 64
sums the i16 rate (which runs beside walk diagonals 0-1).  Then the
trellis form on the same image (``lams=``; rate tables of the image's
first-pass probabilities and its lambdas, ``chip_smoke.first_pass_tables``
and ``trellis_lambdas``), with the same spans and three more: the i16
hook (the AC and Y2 blocks' DP) and the walk candidates' DPs (summed over
the 10 diagonals), both on thread 0, and the chroma quantization and DP
(thread 32).  Prints cycles per MB for each span,
each launch's time and the card's SM clock.  The timers change the kernel's code: its spans say
where the time goes, not what the kernel without them takes.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPANS = {1: "start to the row-above wait's end", 3: "context, i16 mode and code, d16",
         4: "walk end to the s4/s16 barrier", 5: "adoption to the recon barrier",
         6: "hand-over barrier", 9: "output stores and the next MB's inputs",
         7: "i16 rate (thread 64, beside walk diagonals 0-1)",
         20: "trellis: i16 hook, the AC and Y2 DP (in span 3)",
         21: "trellis: walk candidates' DPs (in the diagonals)",
         22: "trellis: chroma quantization and DP (thread 32)"}

T = "if (blockIdx.x == 0 && tid == 0) "
# (anchor text, what goes right after it)
PATCHES = [
    ('#include "wavefront_mb.cuh"\n', "\n__device__ unsigned long long g_clk[32];\n"),
    ("    int seen = 0;             // thread 0: row above's last published count\n",
     "    long long tA = 0, tB = 0, tE = 0, tF = 0, tG = 0, tP = 0;\n"),
    ("    for (int mx = 0; mx < mw; mx++) {\n",
     "      " + T + "{ const long long t = clock64(); if (mx > 0) g_clk[9] += t - tG;"
     " tA = t; g_clk[0] += 1; }\n"),
    ("          if (spins == (1u << 24)) __trap();\n        }\n      }\n      __syncthreads();\n",
     "      " + T + "{ const long long t = clock64(); g_clk[1] += t - tA; tB = t; }\n"),
    ("          vp8::named_barrier_luma();  // the i16 and Y2 levels and both d16"
     " halves are in shared\n",
     "          " + T + "{ const long long t = clock64(); g_clk[3] += t - tB; tP = t; }\n"
     "          const long long t7 = clock64();\n"),
    ("            if (lane == 0) s_s16 = s_d16[0] + s_d16[1] + vp8::mul_shr16(pen, r);\n",
     "            if (blockIdx.x == 0 && tid == 64) g_clk[7] += clock64() - t7;\n"),
    ("            s4 += best >> 4;\n",
     "            " + T + "{ const long long t = clock64(); g_clk[10 + dg] += t - tP;"
     " tP = t; }\n"),
    ("          vp8::named_barrier_luma();  // s16, s4, the walk's modes, levels and"
     " scratch are in shared\n",
     "          " + T + "{ const long long t = clock64(); g_clk[4] += t - tP; tE = t; }\n"),
    ("        vp8::named_barrier_luma();  // the whole MB's recon is in sy\n",
     "        " + T + "{ const long long t = clock64(); g_clk[5] += t - tE; tF = t; }\n"),
    ("      // ---- hand the MB over to the row below: its bottom pixels and dtop\n"
     "      // are stored; release them (cumulative over the block's stores,\n"
     "      // which the barrier ordered before it) ----\n      __syncthreads();\n",
     "      " + T + "{ const long long t = clock64(); g_clk[6] += t - tF; tG = t; }\n"),
    # the trellis form's DPs
    ("        auto refine16 = [&](const int* cf, int y2c, int* lvx, int& l2) {\n",
     "          const long long tH = clock64();\n"),
    ("            if (warp == 0 && half == 0) s_lv[384 + vp8::inv_zigzag(k)] = (int16_t)l2;\n"
     "          }\n",
     "          " + T + "g_clk[20] += clock64() - tH;\n"),
    ("          auto refine4 = [&](const int* cf, int* lv) {\n",
     "            const long long tD = clock64();\n"),
    ("              vp8::trellis_lanes<5>(cf, lv, k, lam, ty, T, s_zrun);\n            }\n",
     "            " + T + "g_clk[21] += clock64() - tD;\n"),
    ("        int16_t* uv = s_lv + 256 + ch * 64;\n", "        const long long tC = clock64();\n"),
    ("                                reinterpret_cast<const vp8::Tables*>(s_tables), s_zrun);\n"
     "        }\n",
     "        if (blockIdx.x == 0 && tid == 32) g_clk[22] += clock64() - tC;\n"),
]
READER = """
extern "C" int wavefront_search_clocks(unsigned long long* out, int reset) {
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
from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm
from gowebp_tpu_torch.utils.corpus import natural_images

dev = torch.device("cuda:0")
lib = wsm.LIBRARY.load()
lib.wavefront_search_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
ch = chip_smoke.chunk_inputs(dev, list(natural_images(1, 1024, 1024, seed=7)))
args = tuple(ch[k].contiguous() for k in ("y", "u", "v", "seg", "qsteps", "pens"))
rate = wsm.search_tables(ch["tables"])
run = lambda: wsm.wavefront_search(*args, rate, try_i4=True, use_derr=True,
                                   want_recon=False)
first = run()
tables = chip_smoke.first_pass_tables(first, dev)
trellis = wsm.search_tables(tables, trellis=True)
lams = chip_smoke.trellis_lambdas(args[4])
run_t = lambda: wsm.wavefront_search(*args, trellis, try_i4=True, use_derr=True,
                                     want_recon=False, lams=lams)
run_t()
buf = (ctypes.c_ulonglong * 32)()
out = {}
for tag, fn in (("", run), ("trellis_", run_t)):
    assert lib.wavefront_search_clocks(buf, 1) == 0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record(); fn(); b.record(); b.synchronize()
    assert lib.wavefront_search_clocks(buf, 0) == 0
    out.update({tag + "ms": a.elapsed_time(b), tag + "clk": list(buf)})
print(json.dumps(out))
"""


def patched(source: str, patches=PATCHES, reader=READER) -> str:
    for anchor, text in patches:
        if source.count(anchor) != 1:
            raise SystemExit(f"clock tool: anchor not found once: {anchor!r}")
        at = source.index(anchor) + len(anchor)
        source = source[:at] + text + source[at:]
    return source + reader


def clock_run(source: str, patches, reader, run: str):
    """Copy the package into _build/clock, add the timers to the copy's
    kernel ``source``, run ``run`` there (it prints one JSON line) →
    (that line as a dict, the card's name, power limit and SM clock), or
    None on a failure (printed)."""
    work = ROOT / "gowebp_tpu_torch" / "_build" / "clock"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "gowebp_tpu_torch", work / "gowebp_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = work / "gowebp_tpu_torch" / "ops" / "kernels" / source
    cu.write_text(patched(cu.read_text(), patches, reader))
    out = subprocess.run([sys.executable, "-c", run, str(work), str(ROOT)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
        return None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    return json.loads(out.stdout.strip().splitlines()[-1]), card


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("clock_wavefront_search: CUDA is not available", file=sys.stderr)
        return 2
    got = clock_run("wavefront_search.cu", PATCHES, READER, RUN)
    if got is None:
        return 1
    res, card = got
    for tag, form in (("", "method <= 5 form"), ("trellis_", "trellis form")):
        clk, n = res[tag + "clk"], res[tag + "clk"][0]
        print(f"{form}, B=1, one 1024x1024 image: {res[tag + 'ms']:.3f} ms; {n} MBs "
              f"timed ({card})")
        walk = 0.0
        for i in (1, 3):
            print(f"{SPANS[i]:50s} {clk[i] / n:9.1f} cycles/MB")
        for d in range(10):
            walk += clk[10 + d] / n
            print(f"{'walk diagonal ' + str(d):50s} {clk[10 + d] / n:9.1f} cycles/MB")
        for i in (4, 5, 6, 9, 7) + ((20, 21, 22) if tag else ()):
            print(f"{SPANS[i]:50s} {clk[i] / n:9.1f} cycles/MB")
        print(f"{'walk, 10 diagonals':50s} {walk:9.1f} cycles/MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
