#!/usr/bin/env python3
"""Write a copy of this checkout's ``gowebp_tpu_torch`` whose
recon_filter_mb filters each edge in shared memory, for
``tools/ab_kernels.py --kernel vp8_recon``.

    python3 tools/variant_vp8_recon.py _archive/smem_edges
    python3 tools/ab_kernels.py --kernel vp8_recon _archive/smem_edges . . \\
        _archive/smem_edges

The kernel holds each lane's pixel line in registers through the vertical
edges, stores it to the window, and after a warp sync holds a window
column through the horizontal edges: one transpose through shared memory.
The copy's ``filter_mb`` instead loads the 8 pixels of an edge from the
window, filters them and stores the 6 an edge may change, edge by edge,
with the same arithmetic (``edge_complex``, ``edge_simple``) and order.
Both give the same planes; ``ab_kernels.py`` checks that.  The text
replaced is found by its first line and the line after it: the tool fails
when the kernel no longer has either.  OUT must be a directory that
``.gitignore`` lists (``_archive/`` does) and is replaced.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FIRST = "template <int N, int WS, int RS>\n__device__ __forceinline__ void filter_mb("
AFTER = "// Unpack one 32-bit word of 4 pixels into the window.\n"

SMEM_EDGES = """\
// Filter one edge of a pixel line in the window: p points at the line's
// pixel 0, `step` apart (1 along a row, the row stride down a column); the
// edge is between pixels at - 1 and at.
template <bool MB_EDGE>
__device__ __forceinline__ void edge_smem(int* p, int step, int at, int t2,
                                          const EdgeParams& e) {
  int L[8];
#pragma unroll
  for (int i = 0; i < 8; i++) L[i] = p[(at - 4 + i) * step];
  if (e.simple)
    edge_simple(L, 4, t2);
  else
    edge_complex<MB_EDGE>(L, 4, t2, e.il, e.hev_t);
#pragma unroll
  for (int i = 1; i < 7; i++) p[(at - 4 + i) * step] = L[i];
}

template <int N>
__device__ __forceinline__ void filter_line_smem(int* p, int step, bool mb_edge,
                                                 const EdgeParams& e) {
  if (mb_edge) edge_smem<true>(p, step, 4, e.t_mb, e);
  if (e.inner) {
    edge_smem<false>(p, step, 8, e.t_in, e);
    if constexpr (N == 20) {
      edge_smem<false>(p, step, 12, e.t_in, e);
      edge_smem<false>(p, step, 16, e.t_in, e);
    }
  }
}

// Filter one plane's MB in its window, each edge in shared memory (the
// kernel's filter_mb holds the lines in registers); same arguments.
template <int N, int WS, int RS>
__device__ __forceinline__ void filter_mb(int* win, const int* rec, int j, bool mine, bool on,
                                          bool hl, bool ht, const EdgeParams& e) {
  if (mine) {
    int* wrow = win + (4 + j) * WS;
#pragma unroll
    for (int c = 4; c < N; c++) wrow[c] = rec[j * RS + c - 4];
  }
  __syncwarp();
  if (mine && on) filter_line_smem<N>(win + (4 + j) * WS, 1, hl, e);
  __syncwarp();
  if (mine && on) filter_line_smem<N>(win + 4 + j, WS, ht, e);
  __syncwarp();
}

"""


def variant(source: str) -> str:
    if source.count(FIRST) != 1 or source.count(AFTER) != 1:
        raise SystemExit("variant_vp8_recon: filter_mb not found once in vp8_recon.cu")
    a, b = source.index(FIRST), source.index(AFTER)
    return source[:a] + SMEM_EDGES + source[b:]


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[1]).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "gowebp_tpu_torch", out / "gowebp_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = out / "gowebp_tpu_torch" / "ops" / "kernels" / "vp8_recon.cu"
    cu.write_text(variant(cu.read_text()))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
