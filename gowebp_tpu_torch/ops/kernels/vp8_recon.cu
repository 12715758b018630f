// The lossy decode's reconstruction and in-loop deblocking filter, fused
// into one persistent launch over the macroblock wavefront: each MB is
// filtered while its pixels are still in shared memory.
//
// Replaces gowebp_tpu/ops/vp8_recon_jax.py recon_wavefront (with the
// residual iDCT) and loop_filter_wavefront, which the JAX package ran in
// XLA (no pallas_call), one after the other over the whole frame; the
// plain versions are ops/vp8_recon.py's recon_wavefront followed by
// loop_filter_wavefront, which step the frame one anti-diagonal at a time
// with some 1,200 small torch ops each.
//
// Bound on the card: by the roofline, operations (the iDCT, the
// predictions and the filtered pixel lines) over bytes (the int16
// coefficients in, the planes out once).  Unreachable: MB (my, mx) needs
// the row above up to MB mx + 1, so an image is a chain of (mw - 1) +
// 2 * (mh - 1) + 1 dependent MB steps (190 at 64x64 MBs), and the time of
// one step sets the kernel's.  The design shortens the step:
//
// - One launch, as libwebp decodes: prediction reads unfiltered pixels,
//   so the recon of each MB row stores its unfiltered bottom row in a
//   top-samples buffer (libwebp's yuv_t_) for the row below, and each MB
//   is filtered right after its recon.  The one wait rule covers both:
//   MB (my, mx) starts once row my - 1 has published min(mx + 2, mw) MBs,
//   which gives the prediction its top-right context and the top edge the
//   pixels that MB (my - 1, mx + 1)'s left edge wrote.  A row publishes an
//   MB after filtering it.
// - wavefront_fixed.cu's persistent rows, two MB rows a block: a
//   block owns a pair of MB rows of one image at a time, warps 0-1 row my
//   and warps 2-3 row my + 1, which walks two MBs behind, so the hand-over
//   inside the pair is the block's barrier and not L2.  Pairs are claimed
//   from an atomic ticket in row-major order across the batch (ticket =
//   pair * B + b), so a block only waits on a row that an earlier-started,
//   running block holds: no deadlock, whatever the grid or the residency.
//   Before each step thread 0 spins on ld.acquire.gpu until the row above
//   the pair has published min(mx + 2, mw) MBs (a stuck wait traps and
//   fails the launch), then the block syncs; after the step's stores the
//   block syncs and the lower row's first thread publishes mx + 1 with
//   st.release.gpu.  One row a block (64 threads) was slower at B=32 and
//   tied on one image (PERF.md).
// - One round of L2 loads a step (__ldcg, never a stale L1 line): the
//   unfiltered top context from the top-samples buffer (21 luma bytes, 9
//   a chroma plane) and the 4 filtered rows above the MB (64 luma bytes,
//   32 a chroma plane, one 32-bit word a lane).  The left context needs no
//   load: the unfiltered left column stays in the recon scratch, and the
//   filtered right 4 columns of MB mx - 1 stay in the filter window.
// - Writes: the MB's filtered 16x16 (8x8) with 16 (8) byte row stores,
//   and where the MB's edges changed them, the 3 columns of MB mx - 1 (as
//   the aligned word of its columns 12-15) and the 3 rows of MB
//   (my - 1, mx) beside it.  Each is final for its rows of the row above:
//   later only MB (my, mx + 1)'s left edge and MB (my + 1, mx)'s top edge
//   change this MB, and each writes what it changed.
//
// 64 threads a row: its first warp luma, its second chroma (U on lanes
// 0-15, V on 16-31).  The MB's modes, its filter parameters and the
// residual iDCT of its 24 blocks come before the wait (they read only the
// MB's own inputs), lane-parallel: a 16-lane segment holds one 4x4 block
// (vp8_dsp.cuh idct_lanes).  Luma context sits in a (17, 21) scratch as in
// wavefront_mb.cuh: row 0 [corner, top 16, top-right 4], column 0 the left
// 16, the interior the recon.  An i16 MB predicts its 256 pixels in 8
// rounds of 2 blocks; an i4 MB walks its 16 sub-blocks on the slope-2
// diagonals d = 2 * gy + gx (10 steps of at most 2 sub-blocks, one a
// segment), each pixel from a per-(mode, pixel) table of three scratch
// offsets (wavefront_mb.cuh pred_b4_lane), whose entry for each diagonal
// every lane gathers into registers before the wait.  Chroma predicts its
// two 8x8 blocks, 4 pixels a lane.
//
// The stripe form (kStripe, a template parameter) decodes one stripe of MB
// rows of a frame split over devices (gowebp_tpu_torch/parallel/shard.py
// sharded_recon_frame, after gowebp_tpu/ops/vp8_recon_jax.py:340-370 with
// axis_name): it stores its last MB row's unfiltered bottom row in the
// top-samples buffer too (the halo of the stripe below), and below another
// stripe (`hts` given) its MB row 0 has a row above: prediction reads that
// stripe's unfiltered bottom row from `hts`, the top edge's filter its 4
// filtered bottom rows from `hf`, and writes the 3 rows it changes back
// into `hf`, which the caller sends up.  The halo is whole before the
// launch, so row 0 waits on nothing.
//
// The filter, in libwebp's order (left MB edge, inner vertical edges, top
// MB edge, inner horizontal edges), runs on a window of the 4 rows above,
// the 4 columns left and the MB (20x20 luma, 12x12 a chroma plane), one
// lane a pixel line held in registers: lane j first holds window row
// 4 + j (the left strip and its recon row) through the vertical edges,
// stores it, and after a warp sync holds window column 4 + j through the
// horizontal edges.  16 luma lanes on the luma warp; 8 U and 8 V lanes on
// the chroma warp.  Each edge is branch-free (every candidate computed,
// each pixel selected), so lanes that take different paths do not run
// them one after another.

#include <cuda_runtime.h>

#include <cstdint>

#include "vp8_dsp.cuh"
#include "wavefront_mb.cuh"

namespace {

using vp8::kCW;
using vp8::kSW;
using vp8::clip8;
using vp8::ld_acquire;
using vp8::pack4;
using vp8::pred_b4_lane;
using vp8::pred_entry;
using vp8::st_release;
using vp8::store_row16;
using vp8::store_row8;

constexpr int kModeBytes = 18;  // per MB: is_i4, uvmode, imodes x16
constexpr int kWY = 21;         // luma window row: left 4, MB 16 (odd: no bank conflicts)
constexpr int kWC = 13;         // chroma window row: left 4, MB 8
constexpr int kRows = 2;        // MB rows a block walks at once

// Spin until *p >= need (thread 0 of a block); a wait of seconds means a
// broken hand-over: fail the launch with an error instead of hanging the card.
__device__ __forceinline__ void wait_progress(const int* p, int need, int& seen) {
  for (unsigned spins = 0; seen < need; spins++) {
    seen = ld_acquire(p);
    if (spins == (1u << 22)) __trap();
  }
}

// Claim the next group of MB rows: returns the ticket (group * B + b), or
// -1 when none is left.  Called by every thread of the block.
__device__ __forceinline__ int claim_rows(int* ticket, int groups, int* s_row) {
  __syncthreads();  // the last group's shared state is no longer read
  if (threadIdx.x == 0) *s_row = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_row < groups ? *s_row : -1;
}

// ---------------------------------------------------------------------------
// Loop filter (RFC 6386 section 15), the arithmetic of ops/vp8_recon.py
// _lanes_complex and _lanes_simple on one pixel line held in registers:
// L[o + i] for i = -4..3 holds p3..q3.  Every call site passes a literal
// o, so the line stays in registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
__device__ __forceinline__ int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

// Complex filter: a macroblock edge (hev ? filter2 : filter6) or an inner
// edge (hev ? filter2 : filter4).  Branch-free: every candidate is
// computed and each pixel selected, so lanes that take different paths
// do not run them one after another.
template <bool MB_EDGE, int N>
__device__ __forceinline__ void edge_complex(int (&L)[N], int o, int t2, int it, int hev_t) {
  const int p3 = L[o - 4], p2 = L[o - 3], p1 = L[o - 2], p0 = L[o - 1];
  const int q0 = L[o], q1 = L[o + 1], q2 = L[o + 2], q3 = L[o + 3];
  const int interior = max(max(max(abs(p3 - p2), abs(p2 - p1)), max(abs(q3 - q2), abs(q2 - q1))),
                           max(abs(p1 - p0), abs(q1 - q0)));
  const bool on = 4 * abs(p0 - q0) + abs(p1 - q1) <= t2 && interior <= it;
  const bool hev = max(abs(p1 - p0), abs(q1 - q0)) > hev_t;
  const bool soft = on && !hev;
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int hp0 = clip8(p0 + sclip2((a + 3) >> 3)), hq0 = clip8(q0 - sclip2((a + 4) >> 3));
  if (MB_EDGE) {
    const int w = sclip1(a);
    const int b1 = (27 * w + 63) >> 7, b2 = (18 * w + 63) >> 7, b3 = (9 * w + 63) >> 7;
    L[o - 3] = soft ? clip8(p2 + b3) : p2;
    L[o - 2] = soft ? clip8(p1 + b2) : p1;
    L[o - 1] = on ? (hev ? hp0 : clip8(p0 + b1)) : p0;
    L[o] = on ? (hev ? hq0 : clip8(q0 - b1)) : q0;
    L[o + 1] = soft ? clip8(q1 - b2) : q1;
    L[o + 2] = soft ? clip8(q2 - b3) : q2;
  } else {
    const int w = 3 * (q0 - p0);
    const int b1 = sclip2((w + 4) >> 3), b2 = sclip2((w + 3) >> 3), b3 = (b1 + 1) >> 1;
    L[o - 2] = soft ? clip8(p1 + b3) : p1;
    L[o - 1] = on ? (hev ? hp0 : clip8(p0 + b2)) : p0;
    L[o] = on ? (hev ? hq0 : clip8(q0 - b1)) : q0;
    L[o + 1] = soft ? clip8(q1 - b3) : q1;
  }
}

// Simple filter (luma only): p1, p0, q0, q1.
template <int N>
__device__ __forceinline__ void edge_simple(int (&L)[N], int o, int t2) {
  const int p1 = L[o - 2], p0 = L[o - 1], q0 = L[o], q1 = L[o + 1];
  const bool on = 4 * abs(p0 - q0) + abs(p1 - q1) <= t2;
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  L[o - 1] = on ? clip8(p0 + sclip2((a + 3) >> 3)) : p0;
  L[o] = on ? clip8(q0 - sclip2((a + 4) >> 3)) : q0;
}

struct EdgeParams {
  int t_mb, t_in, il, hev_t;  // thresholds of the MB edges and the inner edges
  bool inner, simple;
};

// One line across this direction's edges: the MB edge at 4 where `mb_edge`
// (the MB has a neighbour that side), the inner edges at 8 .. N - 4.
template <int N>
__device__ __forceinline__ void filter_line(int (&L)[N], bool mb_edge, const EdgeParams& e) {
  if (e.simple) {
    if (mb_edge) edge_simple(L, 4, e.t_mb);
    if (e.inner) {
      edge_simple(L, 8, e.t_in);
      if constexpr (N == 20) {
        edge_simple(L, 12, e.t_in);
        edge_simple(L, 16, e.t_in);
      }
    }
  } else {
    if (mb_edge) edge_complex<true>(L, 4, e.t_mb, e.il, e.hev_t);
    if (e.inner) {
      edge_complex<false>(L, 8, e.t_in, e.il, e.hev_t);
      if constexpr (N == 20) {
        edge_complex<false>(L, 12, e.t_in, e.il, e.hev_t);
        edge_complex<false>(L, 16, e.t_in, e.il, e.hev_t);
      }
    }
  }
}

// Filter one plane's MB in its window `win` (row stride WS, N = 4 + MB
// size rows and columns; rows 0-3 the filtered rows above, columns 0-3 the
// filtered right columns of the MB to the left); the lanes with `mine`
// take line j (j < N - 4), every lane of the warp calls.  The recon of the
// MB is read from `rec` (row stride RS, the MB's pixel (r, c) at
// rec[r * RS + c]) into the window on the way, filtered or not (`on`).
template <int N, int WS, int RS>
__device__ __forceinline__ void filter_mb(int* win, const int* rec, int j, bool mine, bool on,
                                          bool hl, bool ht, const EdgeParams& e) {
  int L[N];
  if (mine) {
    int* wrow = win + (4 + j) * WS;
#pragma unroll
    for (int c = 0; c < 4; c++) L[c] = wrow[c];
#pragma unroll
    for (int c = 4; c < N; c++) L[c] = rec[j * RS + c - 4];
    if (on) filter_line(L, hl, e);
#pragma unroll
    for (int c = 0; c < N; c++) wrow[c] = L[c];
  }
  __syncwarp();
  if (mine && on) {
#pragma unroll
    for (int r = 0; r < N; r++) L[r] = win[r * WS + 4 + j];
    filter_line(L, ht, e);
#pragma unroll
    for (int r = 1; r < N; r++) win[r * WS + 4 + j] = L[r];
  }
  __syncwarp();
}

// Unpack one 32-bit word of 4 pixels into the window.
__device__ __forceinline__ void unpack4(int* dst, unsigned w) {
#pragma unroll
  for (int i = 0; i < 4; i++) dst[i] = (w >> (8 * i)) & 255;
}

struct Args {
  const int16_t* coeffs;   // (B, mh * mw, 24, 16) dequantized raster coefficients
  const uint8_t* modes;    // (B, mh * mw, 18): is_i4, uvmode, imodes x16
  const int16_t* fparams;  // (B, mh * mw, 4): limit, ilevel, hev_t, inner; limit < 0: off
  uint8_t* y;              // (B, 16 mh, 16 mw) filtered planes
  uint8_t* u;              // (B, 8 mh, 8 mw)
  uint8_t* v;
  uint8_t* ts;    // top samples: (B * mh, 16 mw) luma, then (B * mh, 8 mw) U and V
  int* progress;  // (B * mh) MBs published per row, zeroed by the caller
  int* ticket;    // zeroed by the caller
  int B, mh, mw;
  int ftype;  // 0 no filter, 1 simple (luma only), 2 complex
  // the stripe form below another stripe: that stripe's unfiltered bottom
  // rows (B, 16 mw) luma, then (B, 8 mw) U and V; and its 4 filtered
  // bottom rows (B, 4, 16 mw) luma, then (B, 4, 8 mw) U and V, into which
  // the top edges' filters write back
  const uint8_t* hts;
  uint8_t* hf;
};

// One MB row's state, kept on chip from MB to MB.
struct RowState {
  int sy[17 * kSW];      // luma: row 0 [tl, top16, tr4], col 0 left16, recon
  int sc[2][9 * kCW];    // U, V: row 0 [tl, top8], col 0 left8, recon
  int res[256];          // luma residual, sub-block n at 16 n + k
  int wy[20 * kWY];      // luma filter window: rows above, left columns, MB
  int wc[2][12 * kWC];   // U, V filter windows
};

template <bool kStripe = false>
__global__ void __launch_bounds__(64 * kRows) recon_filter_mb_kernel(Args a) {
  __shared__ RowState rows[kRows];
  __shared__ unsigned s_ptab[160];  // pred_entry(m, k) at 16 * m + k
  __shared__ int s_row;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = warp >> 1;  // this warp's MB row of the block's pair
  const bool luma_warp = !(warp & 1);
  const int k = lane & 15, half = lane >> 4;
  const int kr = k >> 2, kc = k & 3;
  const int mh = a.mh, mw = a.mw;
  const int W = 16 * mw, H = 16 * mh, Wc = 8 * mw, Hc = 8 * mh;
  RowState& R = rows[sub];
  for (int i = tid; i < 160; i += 64 * kRows) s_ptab[i] = pred_entry(i >> 4, i & 15);
  uint8_t* tsy = a.ts;
  uint8_t* tsc = a.ts + (size_t)a.B * mh * (W + half * Wc);  // chroma warp: U or V

  int t;
  while ((t = claim_rows(a.ticket, a.B * ((mh + kRows - 1) / kRows), &s_row)) >= 0) {
    const int g = t / a.B, b = t - g * a.B;
    const int my = g * kRows + sub;
    const int row = b * mh + my;
    const bool from_halo = kStripe && a.hts != nullptr && my == 0;
    const bool ht = my > 0 || from_halo;
    uint8_t* yp = a.y + (size_t)b * H * W;
    uint8_t* cp = (half ? a.v : a.u) + (size_t)b * Hc * Wc;
    const int y0 = 16 * my, cy0 = 8 * my;
    int seen = 0;  // thread 0: the row above's last published count

    // row `sub` takes MB mx = tick - 2 * sub, two MBs behind the row above
    for (int tick = 0; tick < mw + 2 * (kRows - 1); tick++) {
      const int mx = tick - 2 * sub;
      const bool act = my < mh && mx >= 0 && mx < mw;
      const bool hl = mx > 0;
      const size_t mb = (size_t)row * mw + mx;
      const int x0 = 16 * mx, cx0 = 8 * mx;

      // ---- the MB's own inputs (no other row writes them): modes, filter
      // parameters and the residual iDCT, before the wait ----
      int x[8];  // luma warp: blocks 2 * rnd + half; chroma warp: blocks rnd < 4
      unsigned ent[10];  // luma warp: this lane's i4 prediction entry at each diagonal
      int is4 = 0, mode = 0;  // luma warp: i4, else the i16 mode; chroma warp: uvmode
      EdgeParams e{};
      bool on = false;  // this warp filters the MB
      if (act) {
        const int16_t* cf = a.coeffs + mb * 384;
        const uint8_t* md = a.modes + mb * kModeBytes;
        // (an i4 MB's first B-mode may exceed 3; an i16 MB's is its mode)
        is4 = md[0];
        mode = luma_warp ? min((int)md[2], 3) : md[1];
        if (luma_warp) {
          if (is4) {
#pragma unroll
            for (int d = 0; d < 10; d++) {
              const int gy = (d < 3 ? 0 : (d - 2) >> 1) + half, gx = d - 2 * gy;
              ent[d] = gy <= 3 && gx >= 0 ? s_ptab[16 * min((int)md[2 + 4 * gy + gx], 9) + k] : 0;
            }
          }
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) x[rnd] = cf[(2 * rnd + half) * 16 + k];
          vp8::idct_lanes<8>(x, k);
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) R.res[(2 * rnd + half) * 16 + k] = x[rnd];
        } else {
#pragma unroll
          for (int blk = 0; blk < 4; blk++) x[blk] = cf[(16 + 4 * half + blk) * 16 + k];
          vp8::idct_lanes<4>(x, k);
        }
        if (a.ftype) {
          const int16_t* fp = a.fparams + mb * 4;
          const int limit = fp[0];
          on = limit >= 0 && (luma_warp || a.ftype == 2);
          e = EdgeParams{2 * (limit + 4) + 1, 2 * limit + 1, fp[1], fp[2], fp[3] > 0,
                         a.ftype == 1};
        }
      }

      // ---- wait for the row above: another block's (the lower row of the
      // pair trails by two MBs, which the block's barriers order) ----
      if (tid == 0 && act && my > 0) wait_progress(a.progress + row - 1, min(mx + 2, mw), seen);
      __syncthreads();

      if (act && luma_warp) {
        // ================= luma =================
        // one round of loads: the row above's unfiltered bottom pixels (127
        // above the frame; the last column's top-right repeats its top's
        // end) and its 4 filtered bottom rows, one word a lane
        int top = 127;
        if (lane < 20 && ht) {
          const int col = lane < 16 ? x0 + lane : (mx == mw - 1 ? x0 + 15 : x0 + lane);
          top = __ldcg((from_halo ? a.hts + (size_t)b * W : tsy + (size_t)(row - 1) * W) + col);
        }
        unsigned above = 0;
        if (on && ht && lane < 16)
          above = __ldcg(reinterpret_cast<const unsigned*>(
                             (from_halo ? a.hf + (size_t)(4 * b + kr) * W
                                        : yp + (size_t)(y0 - 4 + kr) * W) +
                             x0) +
                         kc);
        // the unfiltered left column and corner from the previous MB of this
        // row (129 left of the frame)
        const int left = hl ? R.sy[(1 + k) * kSW + 16] : 129;
        const int tl = hl ? R.sy[16] : (ht ? 129 : 127);
        __syncwarp();
        if (half == 0) R.sy[(1 + k) * kSW] = left;
        if (lane == 16) R.sy[0] = tl;
        if (lane < 20) {
          R.sy[1 + lane] = top;
          if (lane >= 16)  // the top-right pixels again for gx = 3 below row 0
            for (int r = 4; r < 16; r += 4) R.sy[r * kSW + 1 + lane] = top;
        }
        if (on && ht && lane < 16) unpack4(R.wy + kr * kWY + 4 + 4 * kc, above);
        __syncwarp();
        if (is4) {
          // Step d reconstructs sub-block (gy0 + half, d - 2 * gy) where it
          // exists: its left, top, top-left and top-right neighbours are on
          // earlier diagonals.
#pragma unroll
          for (int d = 0; d < 10; d++) {
            const int gy = (d < 3 ? 0 : (d - 2) >> 1) + half, gx = d - 2 * gy;
            if (gy <= 3 && gx >= 0) {
              const int n = 4 * gy + gx;
              const int p = pred_b4_lane(ent[d], R.sy, 4 * gy * kSW + 4 * gx);
              R.sy[(4 * gy + kr + 1) * kSW + 4 * gx + kc + 1] = clip8(p + R.res[n * 16 + k]);
            }
            __syncwarp();
          }
        } else {
          const int m = mode;
          const int dcv = vp8::luma_dc(R.sy, half, k, ht, hl);
          const int corner = R.sy[0];
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) {
            const int blk = 2 * rnd + half;
            const int pr_r = 4 * (blk >> 2) + kr, pr_c = 4 * (blk & 3) + kc;
            const int tp = R.sy[1 + pr_c], lf = R.sy[(1 + pr_r) * kSW];
            const int pr = m == 0 ? dcv : m == 1 ? clip8(lf + tp - corner) : m == 2 ? tp : lf;
            x[rnd] = clip8(pr + x[rnd]);
          }
          // the interior is written after every lane read its context
          __syncwarp();
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) {
            const int blk = 2 * rnd + half;
            R.sy[(1 + 4 * (blk >> 2) + kr) * kSW + 1 + 4 * (blk & 3) + kc] = x[rnd];
          }
          __syncwarp();
        }
        // the unfiltered bottom row: the row below's top context
        if (lane == 0 && (kStripe || my < mh - 1))
          store_row16(tsy + (size_t)row * W + x0, R.sy + 16 * kSW + 1);

        filter_mb<20, kWY, kSW>(R.wy, R.sy + kSW + 1, lane, lane < 16, on, hl, ht, e);

        // ---- stores: the MB's rows, and what its edges changed of the MB
        // to the left (columns 13-15, as the word of columns 12-15) and of
        // the MB above (rows 13-15) ----
        if (lane < 16) {
          int* wr = R.wy + (4 + lane) * kWY;
          uint8_t* out = yp + (size_t)(y0 + lane) * W + x0;
          store_row16(out, wr + 4);
          if (on && hl) *reinterpret_cast<unsigned*>(out - 4) = pack4(wr);
#pragma unroll
          for (int c = 0; c < 4; c++) wr[c] = wr[16 + c];  // the next MB's left columns
        } else if (on && ht && lane < 19) {
          const int r = lane - 15;  // window rows 1-3
          store_row16((from_halo ? a.hf + (size_t)(4 * b + r) * W : yp + (size_t)(y0 - 4 + r) * W) +
                          x0,
                      R.wy + r * kWY + 4);
        }
      } else if (act) {
        // ================= chroma: segment `half` takes U or V =================
        int* S = R.sc[half];
        int* win = R.wc[half];
        // the stripe form's filtered rows above, this warp's plane (U or V)
        uint8_t* chalo = nullptr;
        if (from_halo) chalo = a.hf + (size_t)a.B * 4 * (W + half * Wc) + (size_t)b * 4 * Wc;
        int top = 127;
        if (k < 8 && ht)
          top = __ldcg((from_halo ? a.hts + (size_t)a.B * (W + half * Wc) + (size_t)b * Wc
                                  : tsc + (size_t)(row - 1) * Wc) +
                       cx0 + k);
        unsigned above = 0;
        if (on && ht && k < 8)
          above = __ldcg(reinterpret_cast<const unsigned*>(
                             (from_halo ? chalo + (size_t)(k >> 1) * Wc
                                        : cp + (size_t)(cy0 - 4 + (k >> 1)) * Wc) +
                             cx0) +
                         (k & 1));
        const int left = hl ? S[(1 + (k & 7)) * kCW + 8] : 129;
        const int tl = hl ? S[8] : (ht ? 129 : 127);
        __syncwarp();
        if (k < 8) {
          S[1 + k] = top;
          if (on && ht) unpack4(win + (k >> 1) * kWC + 4 + 4 * (k & 1), above);
        } else {
          S[(k - 7) * kCW] = left;
          if (k == 8) S[0] = tl;
        }
        __syncwarp();
        int sum = k < 8 ? S[1 + k] : S[(k - 7) * kCW];  // top8, then left8
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(vp8::kFullMask, sum, o);
        const int dcv = vp8::dc_whole(vp8::seg_get(sum, 0), vp8::seg_get(sum, 8), ht, hl, 8);
        const int m = mode, corner = S[0];
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int pr_r = 4 * (blk >> 1) + kr, pr_c = 4 * (blk & 1) + kc;
          const int tp = S[1 + pr_c], lf = S[(1 + pr_r) * kCW];
          const int pr = m == 0 ? dcv : m == 1 ? clip8(lf + tp - corner) : m == 2 ? tp : lf;
          x[blk] = clip8(pr + x[blk]);
        }
        __syncwarp();
#pragma unroll
        for (int blk = 0; blk < 4; blk++)
          S[(1 + 4 * (blk >> 1) + kr) * kCW + 1 + 4 * (blk & 1) + kc] = x[blk];
        __syncwarp();
        if (k == 0 && (kStripe || my < mh - 1))
          store_row8(tsc + (size_t)row * Wc + cx0, S + 8 * kCW + 1);

        filter_mb<12, kWC, kCW>(win, S + kCW + 1, k, k < 8, on, hl, ht, e);

        if (k < 8) {
          int* wr = win + (4 + k) * kWC;
          uint8_t* out = cp + (size_t)(cy0 + k) * Wc + cx0;
          store_row8(out, wr + 4);
          if (on && hl) *reinterpret_cast<unsigned*>(out - 4) = pack4(wr);
#pragma unroll
          for (int c = 0; c < 4; c++) wr[c] = wr[8 + c];
        } else if (on && ht && k < 11) {
          const int r = k - 7;
          store_row8((from_halo ? chalo + (size_t)r * Wc : cp + (size_t)(cy0 - 4 + r) * Wc) + cx0,
                     win + r * kWC + 4);
        }
      }

      // ---- hand the MB over to the row below (the release is cumulative
      // over the block's stores, which the barrier ordered before it) ----
      __syncthreads();
      if (act && sub == kRows - 1 && (tid & 63) == 0) st_release(a.progress + row, mx + 1);
    }
  }
}

template <typename K>
int resident_blocks(K kernel, int threads, int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -(int)err;
    *cache = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return *cache;
}

}  // namespace

// Reconstructs and filters the whole batch as one launch on `stream`.
// `ts` holds B*mh*32*mw bytes of top samples; `sync` B*mh progress
// counters and the ticket, all zero.  `ftype` 0 filters nothing, 1 the
// simple filter (luma only), 2 the complex one.  `stripe` nonzero runs
// the stripe form: `ts` also gets the last MB row's unfiltered bottom row
// (the stripe below's `hts`).  Below another stripe, `hts` (B * 32 * mw
// bytes: luma rows, then U, then V) holds its unfiltered bottom rows and
// `hf` (B * 128 * mw bytes: 4 luma rows an image, then 4 U rows, then 4 V
// rows) its filtered bottom rows, of which the top edges' filters rewrite
// rows 1-3; the frame's top stripe, and the frame, pass both null.
// Returns the CUDA error of the launch (0 = accepted).
extern "C" int recon_filter_mb_launch(const int16_t* coeffs, const uint8_t* modes,
                                      const int16_t* fparams, uint8_t* y, uint8_t* u,
                                      uint8_t* v, uint8_t* ts, int* sync, int B, int mh, int mw,
                                      int ftype, int stripe, const uint8_t* hts, uint8_t* hf,
                                      void* stream) {
  if (B <= 0 || mh <= 0 || mw <= 0) return 0;
  if ((hts != nullptr) != (hf != nullptr) || (hts && !stripe))
    return (int)cudaErrorInvalidValue;
  const Args a{coeffs, modes, fparams, y, u, v, ts, sync, sync + B * mh, B, mh, mw, ftype,
               hts, hf};
  const int groups = B * ((mh + kRows - 1) / kRows);
  const cudaStream_t st = (cudaStream_t)stream;
  if (stripe) {
    static int cache = 0;
    const int resident = resident_blocks(recon_filter_mb_kernel<true>, 64 * kRows, &cache);
    if (resident < 0) return -resident;
    recon_filter_mb_kernel<true><<<groups < resident ? groups : resident, 64 * kRows, 0, st>>>(a);
  } else {
    static int cache = 0;
    const int resident = resident_blocks(recon_filter_mb_kernel<false>, 64 * kRows, &cache);
    if (resident < 0) return -resident;
    recon_filter_mb_kernel<false><<<groups < resident ? groups : resident, 64 * kRows, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
