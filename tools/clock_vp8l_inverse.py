#!/usr/bin/env python3
"""Where the predictor_inverse kernel's time goes, from clock64() and
%globaltimer timers, on one CUDA card.

    python3 tools/clock_vp8l_inverse.py [B H W]

Copies this checkout's ``gowebp_tpu_torch`` into
``gowebp_tpu_torch/_build/clock/`` (which ``.gitignore`` lists), adds
timers to the copy's ``ops/kernels/vp8l_inverse.cu`` at fixed points (each
found by its text: the tool fails when the kernel no longer has one),
builds the copy with nvcc and runs it once on random residuals at bits 4
with the add-green epilogue (default B=1, 1024x1024).  Lane 0 of every
warp of image 0 records: when it started (the global timer, after its
ticket), when its loop started (its wait for the row above over), when
it finished, and, in cycles, its loop, the wait for its copies and the
check of (and any wait for) the row-above words at each iteration's
head, the 4 steps (with the window's reads), and the iteration's tail
(the residual and row-above copies), with its iterations (4 steps each).  Prints these for every 8th row group, the
cycles a step over all groups, and the mean lag from one group's loop
start to the next's.  The timers change the kernel's code: the spans say
where the time goes, not what the kernel without them takes.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import sys

from clock_wavefront_search import clock_run

N = 8192  # warps timed at most
K = 8     # words a warp: start, wait end, end (ns); loop, check, steps, tail
          # (cycles); iterations
GT = ('  unsigned long long gt_; asm volatile("mov.u64 %0, %%globaltimer;" '
      ': "=l"(gt_));\n')
# the end of an iteration: the residual copy and its commit
TAIL = ("    fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + kResAhead, w, r.act);\n"
        "    asm volatile(\"cp.async.commit_group;\" ::: \"memory\");\n")
PATCHES = [
    ("#include <cstdint>\n",
     f"\n__device__ unsigned long long g_clk[{N} * {K}];\n"),
    ("  bool act, odd, top;\n", "  int timed;  // the warp's slot of g_clk, or -1\n"),
    ("  if (g >= groups) return;\n",
     "  {\n" + GT + f"  if (b == 0 && (threadIdx.x & 31) == 0 && g < {N}) g_clk[{K} * g] = gt_; }}\n"),
    ("  r.top = y == 0;\n",
     f"  r.timed = b == 0 && r.lane == 0 && g < {N} ? {K} * g : -1;\n"),
    ("  uint4 o = make_uint4(0u, 0u, 0u, 0u);  // the aligned output vector being gathered\n",
     "  {\n" + GT + "  if (r.timed >= 0) g_clk[r.timed + 1] = gt_; }\n"
     "  long long c_loop = clock64(), c_wait = 0, c_steps = 0, c_tail = 0;\n"),
    ("    const int x0 = 4 * i - kSkew * lane;\n",
     "    const long long c0_ = clock64();\n"),
    ("        if (c + j < w && !(e[j] >> 32)) e[j] = wait_edge(above + c + j);\n    }\n",
     "    const long long c1_ = clock64();\n    c_wait += c1_ - c0_;\n"),
    ("      } else {\n        if (in) r.orow[x] = ov;\n      }\n    }\n",
     "    const long long c3_ = clock64();\n    c_steps += c3_ - c1_;\n"),
    (TAIL, "    c_tail += clock64() - c3_;\n"),
    (TAIL + "    c_tail += clock64() - c3_;\n  }\n",
     "  c_loop = clock64() - c_loop;\n"
     "  {\n" + GT + f"  if (r.timed >= 0) {{ unsigned long long* q_ = g_clk + r.timed;\n"
     "    q_[2] = gt_; q_[3] = c_loop; q_[4] = c_wait; q_[5] = c_steps; q_[6] = c_tail;\n"
     "    q_[7] = r.iters; } }\n"),
]
READER = f"""
extern "C" int vp8l_inverse_clocks(unsigned long long* out, int reset) {{
  static unsigned long long z[{N} * {K}];
  return reset ? (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z))
               : (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));
}}
"""

RUN = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from gowebp_tpu_torch.ops.kernels import vp8l_inverse as vim

B, H, W = (int(a) for a in sys.argv[3:6])
dev = torch.device("cuda:0")
lib = vim.LIBRARY.load()
lib.vp8l_inverse_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
g = torch.Generator().manual_seed(5)
res = torch.randint(-2**31, 2**31 - 1, (B, H, W), generator=g,
                    dtype=torch.int32).to(dev)
th, tw = -(-H // 16), -(-W // 16)
modes = ((torch.randint(0, 14, (th, tw), generator=g, dtype=torch.int32) << 8)
         | (255 << 24)).to(torch.int32).to(dev)
run = lambda: vim.predictor_inverse(res, modes, 4, True)
run()
n = """ + str(N * K) + r"""
buf = (ctypes.c_ulonglong * n)()
assert lib.vp8l_inverse_clocks(buf, 1) == 0
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record(); run(); b.record(); b.synchronize()
assert lib.vp8l_inverse_clocks(buf, 0) == 0
groups = -(-H // 32)
print(json.dumps({"ms": a.elapsed_time(b), "groups": groups,
                  "clk": list(buf)[:""" + str(K) + r""" * min(groups, """ + str(N) + r""")]}))
"""


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("clock_vp8l_inverse: CUDA is not available", file=sys.stderr)
        return 2
    B, H, W = (int(a) for a in argv[1:4]) if len(argv) > 3 else (1, 1024, 1024)
    got = clock_run("vp8l_inverse.cu", PATCHES, READER,
                    RUN.replace("sys.argv[3:6]", f"({B}, {H}, {W})"))
    if got is None:
        return 1
    res, card = got
    clk, groups = res["clk"], res["groups"]
    rec = [clk[K * k:K * k + K] for k in range(groups)]
    t0 = rec[0][0]
    print(f"B={B} {H}x{W} bits 4, add-green: {res['ms']:.3f} ms, {groups} row "
          f"groups ({card})")
    print(f"{'group':>6s} {'start us':>9s} {'loop from':>10s} {'loop us':>8s} "
          f"{'cyc/step':>9s} {'check':>7s} {'steps':>7s} {'tail':>7s}")
    tot = [0, 0, 0, 0, 0]
    for k, (gs, ge, gend, cl, cw, cs, ct, it) in enumerate(rec):
        n = 4 * it
        tot = [a + b for a, b in zip(tot, (n, cl, cw, cs, ct))]
        if k % 8 == 0 or k == groups - 1:
            print(f"{k:6d} {(gs - t0) / 1e3:9.2f} {(ge - t0) / 1e3:10.2f} "
                  f"{(gend - ge) / 1e3:8.2f} {cl / n:9.1f} {cw / n:7.1f} "
                  f"{cs / n:7.1f} {ct / n:7.1f}")
    n, cl, cw, cs, ct = tot
    print(f"cycles a step, all groups: loop {cl / n:.1f} = lane 0's row-above "
          f"check {cw / n:.1f} + the 4 steps {cs / n:.1f} + the iteration's "
          f"tail {ct / n:.1f} (and the window loads)")
    if groups > 1:
        lag = (rec[-1][1] - rec[0][1]) / (groups - 1) / 1e3
        print(f"a group boundary: {lag:.2f} us from one group's loop start to "
              f"the next's (mean); last group ends "
              f"{(rec[-1][2] - t0) / 1e3:.2f} us after the first starts")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
