// The lossy decode's reconstruction and in-loop deblocking filter, as two
// persistent launches over the macroblock wavefront.
//
// Replaces gowebp_tpu/ops/vp8_recon_jax.py recon_wavefront (with the
// residual iDCT) and loop_filter_wavefront, which the JAX package ran in
// XLA (no pallas_call); the plain versions are ops/vp8_recon.py's
// recon_wavefront and loop_filter_wavefront, which step the frame one
// anti-diagonal at a time with some 1,200 small torch ops each.
//
// Bound on the card: by the roofline, bytes (the int16 coefficients in,
// the planes out; the filter reads and writes the planes once).
// Unreachable: MB (my, mx) needs the row above up to MB mx + 1 (the
// top-right context of the prediction, and the pixels that MB's left-edge
// filter wrote), so an image is a chain of (mw - 1) + 2 * (mh - 1) + 1
// dependent MB steps (190 at 64x64 MBs).  The design is wavefront_fixed.cu's:
//
// - One launch each.  A block owns one MB row of one image at a time and
//   walks it left to right.  Rows are claimed from an atomic ticket in
//   row-major order across the batch (ticket = my * B + b), so a block only
//   waits on a row that an earlier-started, running block holds: no
//   deadlock, whatever the grid or the residency.  The grid is the number
//   of blocks the card holds at once; each loops over tickets.
// - Progress counters.  Before MB (my, mx) thread 0 spins on
//   ld.acquire.gpu until row my - 1 has published min(mx + 2, mw) MBs, then
//   the block syncs; the row above's pixels are read with __ldcg (L2, never
//   a stale L1 line).  After an MB's stores the block syncs and thread 0
//   publishes mx + 1 with st.release.gpu.
// - The filter is a second launch on the same stream: prediction reads
//   unfiltered pixels, so it starts once the whole reconstruction is done.
//
// recon_mb, 64 threads: warp 0 luma, warp 1 chroma (U on lanes 0-15, V on
// 16-31).  The residual iDCT of the MB's 24 blocks runs before the wait
// (it reads only the MB's own coefficients), lane-parallel: a 16-lane
// segment holds one 4x4 block (vp8_dsp.cuh idct_lanes).  Luma context sits
// in a (17, 21) scratch as in wavefront_mb.cuh: row 0 [corner, top 16,
// top-right 4], column 0 the left 16, the interior the recon; the left
// column and corner of the next MB stay on chip.  An i16 MB predicts its
// 256 pixels in 8 rounds of 2 blocks; an i4 MB walks its 16 sub-blocks on
// the slope-2 diagonals d = 2 * gy + gx (10 steps of at most 2 sub-blocks,
// one a segment), each pixel from a per-(mode, pixel) table of three
// scratch offsets (wavefront_mb.cuh pred_b4_lane).  Chroma predicts its two
// 8x8 blocks, 4 pixels a lane.
//
// loop_filter_mb, 32 threads: an MB's 20x20 luma and 12x12 chroma windows
// (4 pixels up and left of the MB) are read into shared memory, filtered
// there in libwebp's order (left MB edge, inner vertical edges, top MB
// edge, inner horizontal edges) with one lane per pixel line across an
// edge (16 luma lanes, 8 each for U and V), and written back.  A lane's
// vertical edges stay in its own row and its horizontal edges in its own
// column, so one warp sync between the two directions orders them.

#include <cuda_runtime.h>

#include <cstdint>

#include "vp8_dsp.cuh"
#include "wavefront_mb.cuh"

namespace {

using vp8::kCW;
using vp8::kSW;
using vp8::clip8;
using vp8::ld_acquire;
using vp8::pred_b4_lane;
using vp8::pred_entry;
using vp8::st_release;
using vp8::store_row16;
using vp8::store_row8;

constexpr int kModeBytes = 18;  // per MB: is_i4, uvmode, imodes x16

// Spin until *p >= need (thread 0 of a block); a wait of seconds means a
// broken hand-over: fail the launch with an error instead of hanging the card.
__device__ __forceinline__ void wait_progress(const int* p, int need, int& seen) {
  for (unsigned spins = 0; seen < need; spins++) {
    seen = ld_acquire(p);
    if (spins == (1u << 22)) __trap();
  }
}

// Claim the next MB row: returns the ticket (my * B + b), or -1 when none
// is left.  Called by every thread of the block.
__device__ __forceinline__ int claim_row(int* ticket, int rows, int* s_row) {
  __syncthreads();  // the last row's shared state is no longer read
  if (threadIdx.x == 0) *s_row = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_row < rows ? *s_row : -1;
}

struct ReconArgs {
  const int16_t* coeffs;  // (B, mh * mw, 24, 16) dequantized raster coefficients
  const uint8_t* modes;   // (B, mh * mw, 18): is_i4, uvmode, imodes x16
  uint8_t* y;             // (B, 16 mh, 16 mw) recon planes
  uint8_t* u;             // (B, 8 mh, 8 mw)
  uint8_t* v;
  int* progress;  // (B * mh) MBs published per row, zeroed by the caller
  int* ticket;    // zeroed by the caller
  int B, mh, mw;
};

constexpr int kReconThreads = 64;

__global__ void __launch_bounds__(kReconThreads) recon_mb_kernel(ReconArgs a) {
  __shared__ int sy[17 * kSW];     // luma: row 0 [tl, top16, tr4], col 0 left16, recon
  __shared__ int sc[2][9 * kCW];   // U, V: row 0 [tl, top8], col 0 left8, recon
  __shared__ int s_res[256];       // luma residual, sub-block n at 16 n + k
  __shared__ unsigned s_ptab[160];  // pred_entry(m, k) at 16 * m + k
  __shared__ int s_im[16], s_is4, s_uvm, s_row;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = lane & 15, half = lane >> 4;
  const int kr = k >> 2, kc = k & 3;
  const int mh = a.mh, mw = a.mw;
  const int W = 16 * mw, H = 16 * mh, Wc = 8 * mw, Hc = 8 * mh;
  for (int i = tid; i < 160; i += kReconThreads) s_ptab[i] = pred_entry(i >> 4, i & 15);

  int t;
  while ((t = claim_row(a.ticket, a.B * mh, &s_row)) >= 0) {
    const int my = t / a.B, b = t - my * a.B;
    const int row = b * mh + my;
    const bool ht = my > 0;
    uint8_t* yrec = a.y + (size_t)b * H * W;
    uint8_t* crec = (half ? a.v : a.u) + (size_t)b * Hc * Wc;
    const int y0 = 16 * my, cy0 = 8 * my;
    int seen = 0;  // thread 0: the row above's last published count

    for (int mx = 0; mx < mw; mx++) {
      const bool hl = mx > 0;
      const size_t mb = (size_t)row * mw + mx;
      const int x0 = 16 * mx, cx0 = 8 * mx;
      const int16_t* cf = a.coeffs + mb * 384;

      // ---- the MB's own inputs (no other row writes them): modes and the
      // residual iDCT, before the wait ----
      int x[8];  // warp 0: luma blocks 2 * rnd + half; warp 1: chroma blocks rnd < 4
      if (warp == 0) {
        const uint8_t* md = a.modes + mb * kModeBytes;
        if (lane < 16) s_im[lane] = min((int)md[2 + lane], 9);
        if (lane == 16) s_is4 = md[0];
        if (lane == 17) s_uvm = md[1];
#pragma unroll
        for (int rnd = 0; rnd < 8; rnd++) x[rnd] = cf[(2 * rnd + half) * 16 + k];
        vp8::idct_lanes<8>(x, k);
#pragma unroll
        for (int rnd = 0; rnd < 8; rnd++) s_res[(2 * rnd + half) * 16 + k] = x[rnd];
      } else {
#pragma unroll
        for (int blk = 0; blk < 4; blk++) x[blk] = cf[(16 + 4 * half + blk) * 16 + k];
        vp8::idct_lanes<4>(x, k);
      }

      // ---- wait for the row above ----
      if (tid == 0 && ht) wait_progress(a.progress + row - 1, min(mx + 2, mw), seen);
      __syncthreads();

      if (warp == 0) {
        // ================= luma =================
        // context: the row above's bottom pixels (127 above the frame; the
        // last column's top-right repeats its top's end), the left column
        // and corner from the previous MB of this row (129 left of the frame)
        int top = 127;
        if (lane < 20 && ht) {
          const int col = lane < 16 ? x0 + lane : (mx == mw - 1 ? x0 + 15 : x0 + lane);
          top = __ldcg(yrec + (size_t)(y0 - 1) * W + col);
        }
        const int left = hl ? sy[(1 + k) * kSW + 16] : 129;
        const int tl = hl ? sy[16] : (ht ? 129 : 127);
        __syncwarp();
        if (half == 0) sy[(1 + k) * kSW] = left;
        if (lane == 16) sy[0] = tl;
        if (lane < 20) {
          sy[1 + lane] = top;
          if (lane >= 16)  // the top-right pixels again for gx = 3 below row 0
            for (int r = 4; r < 16; r += 4) sy[r * kSW + 1 + lane] = top;
        }
        __syncwarp();
        if (s_is4) {
          // Step d reconstructs sub-block (gy0 + half, d - 2 * gy) where it
          // exists: its left, top, top-left and top-right neighbours are on
          // earlier diagonals.
          for (int d = 0; d < 10; d++) {
            const int gy0 = d < 3 ? 0 : (d - 2) >> 1;
            const int gy = gy0 + half, gx = d - 2 * gy;
            if (gy <= 3 && gx >= 0) {
              const int n = 4 * gy + gx;
              const int p = pred_b4_lane(s_ptab[16 * s_im[n] + k], sy, 4 * gy * kSW + 4 * gx);
              sy[(4 * gy + kr + 1) * kSW + 4 * gx + kc + 1] = clip8(p + s_res[n * 16 + k]);
            }
            __syncwarp();
          }
        } else {
          // (an i4 MB's first B-mode may exceed 3; an i16 MB's is its mode)
          const int m = min(s_im[0], 3);
          const int dcv = vp8::luma_dc(sy, half, k, ht, hl);
          const int corner = sy[0];
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) {
            const int blk = 2 * rnd + half;
            const int R = 4 * (blk >> 2) + kr, C = 4 * (blk & 3) + kc;
            const int tp = sy[1 + C], lf = sy[(1 + R) * kSW];
            const int pr = m == 0 ? dcv : m == 1 ? clip8(lf + tp - corner) : m == 2 ? tp : lf;
            x[rnd] = clip8(pr + x[rnd]);
          }
          // the interior is written after every lane read its context
          __syncwarp();
#pragma unroll
          for (int rnd = 0; rnd < 8; rnd++) {
            const int blk = 2 * rnd + half;
            sy[(1 + 4 * (blk >> 2) + kr) * kSW + 1 + 4 * (blk & 3) + kc] = x[rnd];
          }
          __syncwarp();
        }
        if (lane < 16) store_row16(yrec + (size_t)(y0 + lane) * W + x0, sy + (1 + lane) * kSW + 1);
      } else {
        // ================= chroma: segment `half` reconstructs U or V =================
        int* S = sc[half];
        int top = 127;
        if (k < 8 && ht) top = __ldcg(crec + (size_t)(cy0 - 1) * Wc + cx0 + k);
        const int left = hl ? S[(1 + (k & 7)) * kCW + 8] : 129;
        const int tl = hl ? S[8] : (ht ? 129 : 127);
        __syncwarp();
        if (k < 8) {
          S[1 + k] = top;
        } else {
          S[(k - 7) * kCW] = left;
          if (k == 8) S[0] = tl;
        }
        __syncwarp();
        int sum = k < 8 ? S[1 + k] : S[(k - 7) * kCW];  // top8, then left8
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(vp8::kFullMask, sum, o);
        const int dcv = vp8::dc_whole(vp8::seg_get(sum, 0), vp8::seg_get(sum, 8), ht, hl, 8);
        const int m = s_uvm, corner = S[0];
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int R = 4 * (blk >> 1) + kr, C = 4 * (blk & 1) + kc;
          const int tp = S[1 + C], lf = S[(1 + R) * kCW];
          const int pr = m == 0 ? dcv : m == 1 ? clip8(lf + tp - corner) : m == 2 ? tp : lf;
          x[blk] = clip8(pr + x[blk]);
        }
        __syncwarp();
#pragma unroll
        for (int blk = 0; blk < 4; blk++)
          S[(1 + 4 * (blk >> 1) + kr) * kCW + 1 + 4 * (blk & 1) + kc] = x[blk];
        __syncwarp();
        if (k < 8) store_row8(crec + (size_t)(cy0 + k) * Wc + cx0, S + (1 + k) * kCW + 1);
      }

      // ---- hand the MB over to the row below (the release is cumulative
      // over the block's stores, which the barrier ordered before it) ----
      __syncthreads();
      if (tid == 0) st_release(a.progress + row, mx + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Loop filter (RFC 6386 section 15), the arithmetic of ops/vp8_recon.py
// _lanes_complex and _lanes_simple on one pixel line: s[o + i * step] for
// i = -4..3 holds p3..q3.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
__device__ __forceinline__ int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }

// Complex filter: a macroblock edge (hev ? filter2 : filter6) or an inner
// edge (hev ? filter2 : filter4).
__device__ __forceinline__ void filter_complex(int* s, int o, int step, int t2, int it, int hev_t,
                                               bool mb_edge) {
  const int p3 = s[o - 4 * step], p2 = s[o - 3 * step], p1 = s[o - 2 * step], p0 = s[o - step];
  const int q0 = s[o], q1 = s[o + step], q2 = s[o + 2 * step], q3 = s[o + 3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t2) return;
  if (abs(p3 - p2) > it || abs(p2 - p1) > it || abs(p1 - p0) > it || abs(q3 - q2) > it ||
      abs(q2 - q1) > it || abs(q1 - q0) > it)
    return;
  if (abs(p1 - p0) > hev_t || abs(q1 - q0) > hev_t) {
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    s[o - step] = clip8(p0 + sclip2((a + 3) >> 3));
    s[o] = clip8(q0 - sclip2((a + 4) >> 3));
  } else if (mb_edge) {
    const int w = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int b1 = (27 * w + 63) >> 7, b2 = (18 * w + 63) >> 7, b3 = (9 * w + 63) >> 7;
    s[o - 3 * step] = clip8(p2 + b3);
    s[o - 2 * step] = clip8(p1 + b2);
    s[o - step] = clip8(p0 + b1);
    s[o] = clip8(q0 - b1);
    s[o + step] = clip8(q1 - b2);
    s[o + 2 * step] = clip8(q2 - b3);
  } else {
    const int w = 3 * (q0 - p0);
    const int b1 = sclip2((w + 4) >> 3), b2 = sclip2((w + 3) >> 3), b3 = (b1 + 1) >> 1;
    s[o - 2 * step] = clip8(p1 + b3);
    s[o - step] = clip8(p0 + b2);
    s[o] = clip8(q0 - b1);
    s[o + step] = clip8(q1 - b3);
  }
}

// Simple filter (luma only): p1, p0, q0, q1.
__device__ __forceinline__ void filter_simple(int* s, int o, int step, int t2) {
  const int p1 = s[o - 2 * step], p0 = s[o - step], q0 = s[o], q1 = s[o + step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t2) return;
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  s[o - step] = clip8(p0 + sclip2((a + 3) >> 3));
  s[o] = clip8(q0 - sclip2((a + 4) >> 3));
}

struct FilterArgs {
  uint8_t* y;  // (B, 16 mh, 16 mw), filtered in place
  uint8_t* u;  // (B, 8 mh, 8 mw)
  uint8_t* v;
  const int16_t* fparams;  // (B, mh * mw, 4): limit, ilevel, hev_t, inner; limit < 0: off
  int* progress;
  int* ticket;
  int B, mh, mw, simple;
};

constexpr int kFilterThreads = 32;
constexpr int kYWin = 20, kCWin = 12;  // window widths: 4 pixels up and left of the MB

__global__ void __launch_bounds__(kFilterThreads) loop_filter_mb_kernel(FilterArgs a) {
  __shared__ int wy[kYWin * kYWin];
  __shared__ int wc[2 * kCWin * kCWin];  // U, then V
  __shared__ int s_row;

  const int lane = threadIdx.x;
  const int mh = a.mh, mw = a.mw;
  const int W = 16 * mw, H = 16 * mh, Wc = 8 * mw, Hc = 8 * mh;
  // this lane's pixel line across an edge: luma line `lane` (lanes 0-15),
  // or U (16-23) / V (24-31) line lane & 7 with the complex filter
  const bool is_luma = lane < 16;
  const bool active = is_luma || !a.simple;
  const int j = is_luma ? lane : (lane & 7);
  int* win = is_luma ? wy : wc + (lane >= 24 ? kCWin * kCWin : 0);
  const int ww = is_luma ? kYWin : kCWin;

  int t;
  while ((t = claim_row(a.ticket, a.B * mh, &s_row)) >= 0) {
    const int my = t / a.B, b = t - my * a.B;
    const int row = b * mh + my;
    const bool ht = my > 0;
    uint8_t* yp = a.y + (size_t)b * H * W;
    uint8_t* up = a.u + (size_t)b * Hc * Wc;
    uint8_t* vp = a.v + (size_t)b * Hc * Wc;
    int seen = 0;

    for (int mx = 0; mx < mw; mx++) {
      const bool hl = mx > 0;
      const int16_t* fp = a.fparams + ((size_t)row * mw + mx) * 4;
      const int limit = fp[0], il = fp[1], hev_t = fp[2];
      const bool inner = fp[3] > 0;

      if (lane == 0 && ht) wait_progress(a.progress + row - 1, min(mx + 2, mw), seen);
      __syncthreads();

      if (limit >= 0) {
        const int y0 = 16 * my - 4, x0 = 16 * mx - 4, cy0 = 8 * my - 4, cx0 = 8 * mx - 4;
        for (int i = lane; i < kYWin * kYWin; i += kFilterThreads) {
          const int r = y0 + i / kYWin, c = x0 + i % kYWin;
          wy[i] = r >= 0 && c >= 0 ? __ldcg(yp + (size_t)r * W + c) : 0;
        }
        if (!a.simple) {
          for (int i = lane; i < 2 * kCWin * kCWin; i += kFilterThreads) {
            const int q = i % (kCWin * kCWin);
            const int r = cy0 + q / kCWin, c = cx0 + q % kCWin;
            wc[i] = r >= 0 && c >= 0
                        ? __ldcg((i < kCWin * kCWin ? up : vp) + (size_t)r * Wc + c)
                        : 0;
          }
        }
        __syncwarp();

        const int t_mb = 2 * (limit + 4) + 1, t_in = 2 * limit + 1;
        const int last = is_luma ? 16 : 8;  // the inner edges run 4 .. last - 4
        if (active) {
          // vertical edges: this lane's row 4 + j, columns across the edge
          const int o = (4 + j) * ww;
          if (a.simple) {
            if (hl) filter_simple(win, o + 4, 1, t_mb);
            if (inner)
              for (int d = 8; d <= last; d += 4) filter_simple(win, o + d, 1, t_in);
          } else {
            if (hl) filter_complex(win, o + 4, 1, t_mb, il, hev_t, true);
            if (inner)
              for (int d = 8; d <= last; d += 4) filter_complex(win, o + d, 1, t_in, il, hev_t, false);
          }
        }
        __syncwarp();
        if (active) {
          // horizontal edges: this lane's column 4 + j, rows across the edge
          const int o = 4 + j;
          if (a.simple) {
            if (ht) filter_simple(win, o + 4 * ww, ww, t_mb);
            if (inner)
              for (int d = 8; d <= last; d += 4) filter_simple(win, o + d * ww, ww, t_in);
          } else {
            if (ht) filter_complex(win, o + 4 * ww, ww, t_mb, il, hev_t, true);
            if (inner)
              for (int d = 8; d <= last; d += 4)
                filter_complex(win, o + d * ww, ww, t_in, il, hev_t, false);
          }
        }
        __syncwarp();

        // write back what an edge can change: rows and columns 1.. of the
        // window, less the corner above-left of the MB (never filtered)
        for (int i = lane; i < kYWin * kYWin; i += kFilterThreads) {
          const int wr = i / kYWin, wcl = i % kYWin;
          const int r = y0 + wr, c = x0 + wcl;
          if (wr >= 1 && wcl >= 1 && (wr >= 4 || wcl >= 4) && r >= 0 && c >= 0)
            yp[(size_t)r * W + c] = (uint8_t)wy[i];
        }
        if (!a.simple) {
          for (int i = lane; i < 2 * kCWin * kCWin; i += kFilterThreads) {
            const int q = i % (kCWin * kCWin);
            const int wr = q / kCWin, wcl = q % kCWin;
            const int r = cy0 + wr, c = cx0 + wcl;
            if (wr >= 1 && wcl >= 1 && (wr >= 4 || wcl >= 4) && r >= 0 && c >= 0)
              (i < kCWin * kCWin ? up : vp)[(size_t)r * Wc + c] = (uint8_t)wc[i];
          }
        }
      }

      // ---- hand the MB over to the row below ----
      __syncthreads();
      if (lane == 0) st_release(a.progress + row, mx + 1);
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

// Reconstructs the whole batch as one launch on `stream`.  `sync` holds
// B*mh progress counters and the ticket, all zero.  Returns the CUDA error
// of the launch (0 = accepted).
extern "C" int recon_mb_launch(const int16_t* coeffs, const uint8_t* modes, uint8_t* y,
                               uint8_t* u, uint8_t* v, int* sync, int B, int mh, int mw,
                               void* stream) {
  const int rows = B * mh;
  if (rows <= 0 || mw <= 0) return 0;
  static int cache = 0;
  const int resident = resident_blocks(recon_mb_kernel, kReconThreads, &cache);
  if (resident < 0) return -resident;
  ReconArgs a{coeffs, modes, y, u, v, sync, sync + rows, B, mh, mw};
  recon_mb_kernel<<<rows < resident ? rows : resident, kReconThreads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Filters the planes in place as one launch on `stream`; `simple` selects
// the simple filter (luma only).  `sync` as for recon_mb_launch.
extern "C" int loop_filter_mb_launch(uint8_t* y, uint8_t* u, uint8_t* v, const int16_t* fparams,
                                     int* sync, int B, int mh, int mw, int simple,
                                     void* stream) {
  const int rows = B * mh;
  if (rows <= 0 || mw <= 0) return 0;
  static int cache = 0;
  const int resident = resident_blocks(loop_filter_mb_kernel, kFilterThreads, &cache);
  if (resident < 0) return -resident;
  FilterArgs a{y, u, v, fparams, sync, sync + rows, B, mh, mw, simple};
  loop_filter_mb_kernel<<<rows < resident ? rows : resident, kFilterThreads, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
