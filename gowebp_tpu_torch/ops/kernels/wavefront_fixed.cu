// Fixed-mode closed-loop VP8 macroblock encode in wavefront order — the
// hybrid encoder's phase 2 — as one persistent launch.
//
// Replaces the TPU kernel gowebp_tpu/ops/pallas/wavefront_fixed.py
// (wavefront_fixed_pallas -> _make_kernel), which ran the whole anti-
// diagonal wavefront as one grid and kept the boundary state on chip.
//
// Bound on the card: by the roofline, bytes (planes and modes in, levels
// and recon out: 0.03 ms at B=16, 1024x1024).  Unreachable: MB (my, mx)
// needs the recon of (my-1, mx+1), so an image is a chain of
// (mw - 1) + 2*(mh - 1) + 1 dependent MB steps (190 at 64x64 MBs), each a few
// thousand cycles of dependent integer work plus, per row, a hand-over
// through L2.  The design keeps each step short:
//
// - One launch.  A 96-thread block owns one MB row of one image at a time
//   and walks it left to right.  Rows are claimed in order from an atomic
//   ticket (ticket = my*B + b: every image's row 0, then every row 1, ...),
//   so a block only ever waits on a row that an earlier-started, resident
//   block owns: no deadlock, whatever the grid or the residency, and the
//   rows claimed last are the ones that would start last anyway.  The
//   grid is the number of blocks the card holds at once; each loops over
//   tickets.
// - Progress counters.  Before MB (my, mx) thread 0 spins on
//   ld.acquire.gpu until row my-1 has published min(mx + 2, mw) MBs (top,
//   top-left, top-right and the UV DC carries dtop; the last column's
//   top-right repeats its own top), then __syncthreads().  The row
//   above's pixels and dtop are read with __ldcg (L2, never a stale L1
//   line).  After each MB the block stores the bottom recon row and dtop,
//   __syncthreads(), and one thread of warp 2 publishes mx+1 with
//   st.release.gpu (a release is cumulative over the stores the barrier
//   ordered before it).  The other outputs (levels, the other recon rows)
//   are written after the hand-over, off the chain; the next MB's own
//   inputs (source pixels, modes) are fetched one MB ahead.
// - Left context on chip.  The left recon column, the corner and the UV
//   DC carries toward the right come from the previous MB of the same row
//   and stay in shared memory and registers.
// - Lane-parallel 4x4 work (vp8_dsp.cuh): a 16-lane segment holds one
//   4x4 block, one lane per pixel or coefficient; FDCT, IDCT and the Y2
//   WHT/IWHT are two passes of shuffles, with lane-constant multipliers
//   and selects, never a branch on the lane.  Warp 1 codes chroma while
//   warps 0 and 2 code luma:
//   - i16: warp 0 takes sub-blocks 0-7, warp 2 sub-blocks 8-15, each as 4
//     rounds of 2 whose shuffles go out together; after a barrier of the
//     two warps every segment runs the Y2 path (WHT, quantize, IWHT by
//     shuffle), then dequantize, IDCT and recon.
//   - i4: warp 0 runs the 16-sub-block chain in sub-block diagonal order
//     d = 2*gy + gx, 10 steps of up to 2 sub-blocks (one per segment).  A
//     sub-block reads only its left, top, top-left and top-right
//     neighbours (or the MB's top-right pixels when gx = 3), all on
//     earlier diagonals, so every level and pixel equals the raster walk's.
//     The prediction reads a per-(mode, pixel) table of three feature
//     offsets and their weights: no branch on the mode or the pixel.
//   - chroma: one segment per channel, its 4 blocks together; the 2x2 DC
//     error-diffusion chain runs on the segment's lane 0 between the FDCT
//     and the quantization.

#include <cuda_runtime.h>

#include <cstdint>

#include "vp8_dsp.cuh"
#include "wavefront_mb.cuh"

namespace {

using vp8::kCW;
using vp8::kSW;
using vp8::ld_acquire;
using vp8::named_barrier_luma;
using vp8::pred_b4_lane;
using vp8::pred_entry;
using vp8::qsingle_chain;
using vp8::st_release;
using vp8::store_row16;
using vp8::store_row8;

// warp 0: luma (the i4 chain, half the i16 blocks), warp 1: chroma,
// warp 2: the other i16 blocks and the hand-over
constexpr int kThreads = 96;

struct Args {
  const uint8_t* y;  // (B, H, W) source planes
  const uint8_t* u;  // (B, H/2, W/2)
  const uint8_t* v;
  const int* seg;     // (B, mh, mw)
  const int* qsteps;  // (B, 4, 6) y1dc y1ac y2dc y2ac uvdc uvac
  const int* ymode;   // (B, mh, mw)
  const int* uvmode;
  const int* is_i4;
  const int* imodes;  // (B, mh, mw, 16)
  uint8_t* ry;        // (B, H, W) recon planes (the row below reads them)
  uint8_t* ru;
  uint8_t* rv;
  int16_t* dtop;  // (B, mh, mw, 4) UV DC error carries [ch][k] for the MB below
  int16_t* ylv;   // (B, mh, mw, 16, 16) zigzag levels
  int16_t* y2lv;  // (B, mh, mw, 16)
  int16_t* uvlv;  // (B, mh, mw, 8, 16)
  int* progress;  // (B*mh) MBs published per row, zeroed by the caller
  int* ticket;    // next ticket (my * B + b) to claim, zeroed by the caller
  int B, mh, mw, use_derr;
};

// 6 blocks an SM: at most 112 registers, no spills.
__global__ void __launch_bounds__(kThreads, 6) wavefront_fixed_kernel(Args a) {
  __shared__ int sy[17 * kSW];     // luma: row 0 [tl, top16, tr4], col 0 left16, recon
  __shared__ int sc[2][9 * kCW];   // U, V: row 0 [tl, top8], col 0 left8, recon
  __shared__ __align__(16) uint8_t ss[256], scs[2][64];  // the MB's source pixels
  __shared__ int s_dc[16], s_im[16];  // the i16 DCs, the MB's B-modes
  __shared__ int s_q[24], s_iq[24];   // the image's 4 quantizer rows and reciprocals
  __shared__ unsigned s_ptab[160];  // pred_entry(m, k) at 16 * m + k
  __shared__ int s_is4, s_ymode, s_uvmode, s_seg, s_row;
  // the MB's levels (luma 0-255, chroma 256-383, Y2 384-399), written out
  // after the hand-over
  __shared__ __align__(16) int16_t s_lv[400];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = lane & 15, half = lane >> 4;
  const int kr = k >> 2, kc = k & 3;
  const int mh = a.mh, mw = a.mw;
  const int W = 16 * mw, H = 16 * mh, Wc = 8 * mw, Hc = 8 * mh;
  for (int i = tid; i < 160; i += kThreads) s_ptab[i] = pred_entry(i >> 4, i & 15);

  for (;;) {
    __syncthreads();  // the last row's shared state is no longer read
    if (tid == 0) s_row = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = s_row;  // tickets go row by row across the batch
    if (t >= a.B * mh) return;
    const int my = t / a.B, b = t - my * a.B;
    const int row = b * mh + my;
    const bool ht = my > 0;
    const uint8_t* ysrc = a.y + (size_t)b * H * W;
    uint8_t* yrec = a.ry + (size_t)b * H * W;
    const int y0 = 16 * my, cy0 = 8 * my;
    if (tid < 24) {
      const int q = a.qsteps[(size_t)b * 24 + tid];
      s_q[tid] = q;
      s_iq[tid] = (1 << 17) / (q > 1 ? q : 1);
    }
    int seen = 0;             // thread 0: row above's last published count
    int dl0 = 0, dl1 = 0;     // warp 1, lane 0 of each segment: carries to the right

    // This thread's share of an MB's own inputs (no other row writes
    // them), fetched one MB ahead so that their latency is off the chain.
    auto fetch = [&](int mx) {
      const size_t mb = (size_t)row * mw + mx;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (tid < 16) {
        w = __ldg(reinterpret_cast<const uint4*>(ysrc + (size_t)(y0 + tid) * W + 16 * mx));
      } else if (tid < 32) {
        const uint8_t* cs = (tid < 24 ? a.u : a.v) + (size_t)b * Hc * Wc;
        const uint2 c = __ldg(
            reinterpret_cast<const uint2*>(cs + (size_t)(cy0 + (tid & 7)) * Wc + 8 * mx));
        w.x = c.x;
        w.y = c.y;
      } else if (tid < 48) {
        w.x = a.imodes[mb * 16 + tid - 32];
      } else if (tid == 48) {
        w = make_uint4(a.is_i4[mb] != 0, a.ymode[mb], a.uvmode[mb], a.seg[mb]);
      }
      return w;
    };
    uint4 next = fetch(0);

    for (int mx = 0; mx < mw; mx++) {
      const bool hl = mx > 0;
      const size_t mb = (size_t)row * mw + mx;
      const int x0 = 16 * mx, cx0 = 8 * mx;

      // ---- the MB's own inputs into shared memory; fetch the next MB's ----
      {
        if (tid < 16) {
          *reinterpret_cast<uint4*>(ss + 16 * tid) = next;
        } else if (tid < 32) {
          *reinterpret_cast<uint2*>(&scs[tid >= 24][(tid & 7) * 8]) = make_uint2(next.x, next.y);
        } else if (tid < 48) {
          s_im[tid - 32] = (int)next.x;
        } else if (tid == 48) {
          s_is4 = (int)next.x;
          s_ymode = (int)next.y;
          s_uvmode = (int)next.z;
          s_seg = (int)next.w;
        }
        if (mx + 1 < mw) next = fetch(mx + 1);
      }
      // ---- wait for the row above ----
      if (tid == 0 && ht) {
        const int need = min(mx + 2, mw);
        for (unsigned spins = 0; seen < need; spins++) {
          seen = ld_acquire(a.progress + row - 1);
          // A wait of seconds means a broken hand-over: fail the launch
          // with an error instead of hanging the card.
          if (spins == (1u << 22)) __trap();
        }
      }
      __syncthreads();

      // ---- context: the row above's bottom pixels (through L2), the left
      // column and corner from the previous MB of this row (on chip) ----
      int dt0 = 0, dt1 = 0;
      if (warp == 0) {
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
      } else if (warp == 1) {
        int* S = sc[half];
        int top = 127;
        if (k < 8 && ht) {
          const uint8_t* crec = (half ? a.rv : a.ru) + (size_t)b * Hc * Wc;
          top = __ldcg(crec + (size_t)(cy0 - 1) * Wc + cx0 + k);
        }
        if (k == 0 && a.use_derr && ht) {
          const int16_t* p = a.dtop + (mb - mw) * 4 + 2 * half;
          dt0 = __ldcg(p);
          dt1 = __ldcg(p + 1);
        }
        const int left = hl ? S[(1 + (k & 7)) * kCW + 8] : 129;
        const int tl = hl ? S[8] : (ht ? 129 : 127);
        __syncwarp();
        if (k < 8) {
          S[1 + k] = top;
        } else {
          S[(k - 7) * kCW] = left;
          if (k == 8) S[0] = tl;
        }
      }
      __syncwarp();

      if (warp != 1) {
        // ================= luma =================
        named_barrier_luma();  // warp 0's top context is in sy
        const bool is4 = s_is4 != 0;
        const int* q = s_q + 6 * s_seg;
        const int* iq = s_iq + 6 * s_seg;
        const int q0 = q[0], q1 = q[1], iq0 = iq[0], iq1 = iq[1];
        if (is4) {
          if (warp == 0) {
            if (half == 0) s_lv[384 + k] = 0;  // no Y2
            // Step d codes sub-block (gy0 + half, d - 2 * gy) where it
            // exists; a segment without one mirrors segment 0's and stores
            // nothing.
            for (int d = 0; d < 10; d++) {
              const int gy0 = d < 3 ? 0 : (d - 2) >> 1;
              int gy = gy0 + half, gx = d - 2 * gy;
              const bool valid = gy <= 3 && gx >= 0;
              if (!valid) {
                gy = gy0;
                gx = d - 2 * gy0;
              }
              const int n = 4 * gy + gx, R = 4 * gy + kr, C = 4 * gx + kc;
              const int p = pred_b4_lane(s_ptab[16 * s_im[n] + k], sy, 4 * gy * kSW + 4 * gx);
              int x = ss[R * 16 + C] - p;
              vp8::fdct_lanes<1>(&x, k);
              const int lv = vp8::quant_lane(x, k, iq0, iq1, vp8::kBiasY1Dc, vp8::kBiasY1Ac, false);
              x = lv * (k == 0 ? q0 : q1);
              vp8::idct_lanes<1>(&x, k);
              if (valid) {
                s_lv[n * 16 + vp8::inv_zigzag(k)] = (int16_t)lv;
                sy[(R + 1) * kSW + C + 1] = vp8::clip8(p + x);
              }
              __syncwarp();
            }
          }
        } else {
          // warp 0 codes sub-blocks 0-7, warp 2 sub-blocks 8-15
          const int blk0 = warp == 0 ? 0 : 8;
          const int dcv = vp8::luma_dc(sy, half, k, ht, hl);
          const int m = s_ymode, tl = sy[0];
          int x[4], pr[4];  // this warp's 4 rounds of 2 sub-blocks, together
          vp8::code_i16(warp, half, k, m, dcv, tl, sy, ss, q, iq, q1, iq0, iq1, s_dc, s_lv, x,
                        pr);
#pragma unroll
          for (int rnd = 0; rnd < 4; rnd++) {
            const int blk = blk0 + 2 * rnd + half;
            const int R = 4 * (blk >> 2) + kr, C = 4 * (blk & 3) + kc;
            sy[(1 + R) * kSW + 1 + C] = vp8::clip8(pr[rnd] + x[rnd]);
          }
          named_barrier_luma();  // the whole MB's recon is in sy
        }
        if (tid == 15) store_row16(yrec + (size_t)(y0 + 15) * W + x0, sy + 16 * kSW + 1);
      } else {
        // ================= chroma: segment `half` codes channel U or V =================
        const int ch = half;
        int* S = sc[ch];
        int sum = k < 8 ? S[1 + k] : S[(k - 7) * kCW];  // top8, then left8
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(vp8::kFullMask, sum, o);
        const int dcv = vp8::dc_whole(vp8::seg_get(sum, 0), vp8::seg_get(sum, 8), ht, hl, 8);
        const int m = s_uvmode, tl = S[0];
        const int* q = s_q + 6 * s_seg;
        const int* iq = s_iq + 6 * s_seg;
        int cfr[4], pr[4];
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int R = 4 * (blk >> 1) + kr, C = 4 * (blk & 1) + kc;
          const int top = S[1 + C], left = S[(1 + R) * kCW];
          pr[blk] = m == 0 ? dcv : m == 1 ? vp8::clip8(left + top - tl) : m == 2 ? top : left;
          cfr[blk] = scs[ch][R * 8 + C] - pr[blk];
        }
        vp8::fdct_lanes<4>(cfr, k);
        if (a.use_derr && k == 0) {
          int nl[2], nt[2];
          qsingle_chain(cfr, dt0, dt1, dl0, dl1, iq[4], q[4], nl, nt);
          a.dtop[mb * 4 + 2 * ch] = (int16_t)nt[0];
          a.dtop[mb * 4 + 2 * ch + 1] = (int16_t)nt[1];
          dl0 = (int16_t)nl[0];  // the carries are int16 values
          dl1 = (int16_t)nl[1];
        }
        int16_t* uv = s_lv + 256 + ch * 64;
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int lv = vp8::quant_lane(cfr[blk], k, iq[4], iq[5], vp8::kBiasUvDc,
                                         vp8::kBiasUvAc, false);
          uv[blk * 16 + vp8::inv_zigzag(k)] = (int16_t)lv;
          cfr[blk] = lv * (k == 0 ? q[4] : q[5]);
        }
        vp8::idct_lanes<4>(cfr, k);
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int R = 4 * (blk >> 1) + kr, C = 4 * (blk & 1) + kc;
          S[(1 + R) * kCW + 1 + C] = vp8::clip8(pr[blk] + cfr[blk]);
        }
        __syncwarp();
        if (k == 7)
          store_row8((ch ? a.rv : a.ru) + (size_t)b * Hc * Wc + (size_t)(cy0 + 7) * Wc + cx0,
                     S + 8 * kCW + 1);
      }

      // ---- hand the MB over to the row below: its bottom pixels and dtop
      // are stored; release them (cumulative over the block's stores,
      // which the barrier ordered before it) ----
      __syncthreads();
      if (tid == 64) st_release(a.progress + row, mx + 1);  // off warps 0-1's path

      // ---- the rest of the MB's outputs, off the chain ----
      if (tid < 15) {
        store_row16(yrec + (size_t)(y0 + tid) * W + x0, sy + (1 + tid) * kSW + 1);
      } else if (tid >= 16 && tid < 30) {
        const int ch = tid >= 23, r = tid - 16 - 7 * ch;
        store_row8((ch ? a.rv : a.ru) + (size_t)b * Hc * Wc + (size_t)(cy0 + r) * Wc + cx0,
                   sc[ch] + (1 + r) * kCW + 1);
      }
      const uint4* lv4 = reinterpret_cast<const uint4*>(s_lv);
      if (tid >= 64)
        reinterpret_cast<uint4*>(a.ylv + mb * 256)[tid - 64] = lv4[tid - 64];
      else if (tid >= 32 && tid < 48)
        reinterpret_cast<uint4*>(a.uvlv + mb * 128)[tid - 32] = lv4[tid];
      else if (tid >= 48 && tid < 50)
        reinterpret_cast<uint4*>(a.y2lv + mb * 16)[tid - 48] = lv4[tid];
    }
  }
}

}  // namespace

// Runs the whole wavefront as one launch on `stream`.  `sync` holds B*mh
// progress counters and the ticket, all zero.  Returns the CUDA error of
// the launch (0 = accepted).
extern "C" int wavefront_fixed_launch(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                      const int* seg, const int* qsteps, const int* ymode,
                                      const int* uvmode, const int* is_i4, const int* imodes,
                                      uint8_t* ry, uint8_t* ru, uint8_t* rv, int16_t* dtop,
                                      int16_t* ylv, int16_t* y2lv, int16_t* uvlv, int* sync,
                                      int B, int mh, int mw, int use_derr, void* stream) {
  const int rows = B * mh;
  if (rows <= 0 || mw <= 0) return 0;
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wavefront_fixed_kernel, kThreads, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  Args a{y, u, v, seg, qsteps, ymode, uvmode, is_i4, imodes, ry, ru, rv, dtop,
         ylv, y2lv, uvlv, sync, sync + rows, B, mh, mw, use_derr};
  const int grid = rows < resident ? rows : resident;
  wavefront_fixed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
