// Exact full-search closed-loop VP8 macroblock encode in wavefront order
// — the exact engine (engine="wavefront") — as one persistent launch.
//
// Replaces gowebp_tpu/ops/encode_wavefront_jax.py _wavefront_impl with
// modes=None, which the JAX package ran in XLA (no Pallas kernel): every
// MB's modes are searched inside the closed loop, from the recon of the
// MBs coded before it, then the MB is coded with them.
//
// Bound on the card: by the roofline, integer operations (the i4 walk's
// 10 candidates x 16 sub-blocks of every MB, ~0.55 ms at B=16,
// 1024x1024).  Unreachable: as in wavefront_fixed.cu, an image is a chain
// of (mw - 1) + 2*(mh - 1) + 1 dependent MB steps (190 at 64x64 MBs), and
// each step carries a whole i4 walk: 10 dependent diagonal steps of 10 or
// 20 candidate scores each.  The design keeps wavefront_fixed.cu's
// persistent schedule and adds the search to each MB step:
//
// - One launch, 96-thread blocks claiming MB rows by atomic ticket (row by
//   row across the batch), progress counters with ld.acquire/st.release,
//   the left context on chip, the next MB's source fetched one MB ahead
//   (wavefront_mb.cuh; see wavefront_fixed.cu for the argument that no
//   wait can deadlock).
// - i16 mode (warps 0 and 2): each lane takes 4 pixels, predicts them
//   under the 4 whole-block modes and sums the squared errors; a shuffle
//   reduction per warp and a barrier of the two warps give the 4 SSEs,
//   and the first minimum wins (ties to the lowest mode).  Then the
//   lane-parallel i16 code wavefront_fixed.cu runs too (wavefront_mb.cuh
//   code_i16): FDCT, Y2 WHT, quantization, IWHT, IDCT; the i16 recon
//   stays in registers (4 pixels a lane).
// - try_i4 (a template parameter: false compiles to no rate tables and no
//   i4 work):
//   - warp 2 first computes the i16 rate by position (i4_lanes.cuh
//     rate_zigzag: segment h charges AC blocks 8h .. 8h + 7, type 0 from
//     position 1, segment 0 also the Y2 block, type 1; every block with
//     ctx0 = 1) from the levels in shared memory, and s16 = d16 + (pen *
//     rate16) >> 16, d16 the SSE of the source against the i16 recon.  It
//     runs while warp 0 walks the first two diagonals, which hold one
//     sub-block each;
//   - the i4 walk goes in sub-block diagonal order d = 2*gy + gx: 10
//     steps of 1 or 2 sub-blocks.  Each candidate (a B-mode on a
//     sub-block) is scored lane-parallel on a 16-lane segment, one lane
//     per pixel or coefficient (i4_lanes.cuh score_lanes): the
//     prediction from a per-(mode, pixel) table of scratch offsets, the
//     FDCT, quantization, dequantization and IDCT by shuffle, the token
//     rate by position (lane n charges zigzag position n; a ballot gives
//     the last non-zero), the recon and the SSE by segment reduction.  A
//     warp takes one sub-block whole: segment h scores B-modes 5h .. 5h +
//     4 together, so their shuffles go out back to back; warp 0 takes the
//     diagonal's first sub-block, warp 2 the second where there is one.
//     The first minimum of (cost, mode) is the least key cost << 4 |
//     mode: the segment's, then one shuffle against the other segment's.
//     The winning segment writes its recon into the MB's (17, 21) scratch
//     (the next steps' context), its levels and its mode.  A barrier of
//     the two luma warps orders the diagonals from the first that holds
//     two sub-blocks on;
//   - adopt i4 when s4 < s16 (strict: an equal score keeps i16).  An
//     adopted MB writes out the walk's levels and no Y2; otherwise the i16
//     recon goes into the scratch.
//   The trade-off taken: longer rounds (5 candidates a segment, a
//   sub-block a warp) on the two luma warps of a 96-thread block, not more
//   warps.  At B=16 an SM holds 4 blocks (the shared memory's limit),
//   which share its issue slots: spreading a sub-block over more warps
//   cuts the chain of one image but adds leftover slots, a cross-warp
//   argmin and its barrier to every step, and in a trial on an H100 it
//   ran B=16 about twice as long as this layout.  4 resident blocks an SM
//   also keep the 16 wavefronts of up to 32 rows each in flight.
//   The three per-position rate tables (types 0, 1 and 3, 13,824 bytes
//   each) are staged once per resident block in dynamic shared memory
//   (41,472 bytes: the launcher raises the kernel's dynamic limit and
//   sizes the grid from the occupancy at that size, so every block of the
//   ticket grid is resident).
// - uv mode (warp 1, in parallel with the luma work): the joint U+V SSE of
//   the 4 modes, 4 pixels a lane, first minimum; then the chroma code with
//   the UV DC error-diffusion chain, as in wavefront_fixed.cu.
// - The trellis form (kTrellis, a template parameter; the host encoder's
//   second pass at method 6, gowebp_tpu/entropy/native/vp8_dec.cpp
//   trellis_refine with block_rate256's rules): every block's levels are
//   refined right after its quantization by i4_lanes.cuh trellis_lanes,
//   on the segment that already holds the blocks (lane k raster
//   coefficient and level k of each): the DP's step between two non-zero
//   positions is a 2x2 min-plus matrix; the non-zeros of the segment's
//   blocks are packed onto its 16 lanes, one a lane, and a segmented scan
//   of their matrices (at most 4 shuffle steps) gives every non-zero the
//   serial DP's two scores; ballots of the choice bits and a bit-parallel
//   backtrack then lower each lane's own levels.  Each segment refines its
//   4 AC blocks and the Y2 block (every segment holds Y2's coefficients)
//   in one call, before the dequantization, so the i16 recon, d16 and
//   rate16 see the refined levels; its 5 walk candidates before they are
//   scored (so the trellis moves the mode decisions too); its chroma
//   channel's 4 blocks after the DC error diffusion.  No shared memory and
//   no barrier.  Its cost: each call is a chain of some 13 dependent
//   shuffle, ballot or table-load stages (a packing round when the
//   blocks' non-zeros fit 16 lanes, two rounds side by side otherwise),
//   11 calls on each MB step's chain.  The rate tables are those of the
//   first pass's adapted probabilities and add type 2 (chroma) as a fourth
//   table (55,296 bytes of dynamic shared memory, 3 blocks an SM), with
//   each table's zero-run sums (256 bytes, made at the launch's start);
//   the lambdas come per segment (lams).
// - The stripe form (kStripe, a template parameter; method <= 5 only):
//   one stripe of MB rows of a frame split over devices
//   (gowebp_tpu_torch/parallel/shard.py sharded_wavefront_encode, after
//   gowebp_tpu/ops/encode_wavefront_jax.py:616 _wavefront_impl with
//   axis_name), below another stripe.  Its MB row 0 has a row above: it
//   reads the top context from the halo the stripe above sent (its last
//   recon luma row hy, chroma rows hu, hv, and its last MB row's DC
//   carries hdt), which is whole before the launch, so row 0 waits on
//   nothing.  The other forms leave the halo unread.

#include <cuda_runtime.h>

#include <cstdint>

#include "i4_lanes.cuh"
#include "i4_score.cuh"
#include "vp8_dsp.cuh"
#include "wavefront_mb.cuh"

namespace {

using vp8::kCW;
using vp8::kSW;
using vp8::qsingle_chain;
using vp8::store_row16;
using vp8::store_row8;

// warp 0: luma (half the i16 blocks, the i4 walk), warp 1: chroma and its
// mode, warp 2: the other i16 blocks, the i16 rate, its share of the walk
// and the hand-over
constexpr int kThreads = 96;
// the rate tables' dynamic shared memory: types 0, 1, 3, and 2 in the
// trellis form
constexpr int table_bytes(bool i4, bool trellis) {
  return trellis ? 4 * (int)sizeof(vp8::Tables) : i4 ? 3 * (int)sizeof(vp8::Tables) : 0;
}

struct Args {
  const uint8_t* y;  // (B, H, W) source planes
  const uint8_t* u;  // (B, H/2, W/2)
  const uint8_t* v;
  const int* seg;     // (B, mh, mw)
  const int* qsteps;  // (B, 4, 6) y1dc y1ac y2dc y2ac uvdc uvac
  const int* pens;    // (B, 4) per-segment RD lambdas (try_i4 only)
  const int* p0;      // (T, 16, 3, 2) rate tables of types 0, 1, 3 (and 2) by position
  const int* p1;      // (T, 16, 3, 2)
  const int* val;     // (T, 16, 3, 68)
  const int* lams;    // (B, 4) per-segment trellis lambdas (the trellis form only)
  uint8_t* ry;        // (B, H, W) recon planes (the row below reads them)
  uint8_t* ru;
  uint8_t* rv;
  int16_t* dtop;  // (B, mh, mw, 4) UV DC error carries [ch][k] for the MB below
  int16_t* ylv;   // (B, mh, mw, 16, 16) zigzag levels
  int16_t* y2lv;  // (B, mh, mw, 16)
  int16_t* uvlv;  // (B, mh, mw, 8, 16)
  uint8_t* ymode;   // (B, mh, mw) the modes coded
  uint8_t* uvmode;
  uint8_t* is_i4;
  uint8_t* imodes;  // (B, mh, mw, 16); an i16 MB repeats its ymode
  int* progress;    // (B*mh) MBs published per row, zeroed by the caller
  int* ticket;      // next ticket (my * B + b) to claim, zeroed by the caller
  int B, mh, mw, use_derr;
  // the stripe form: the stripe above's last recon rows and DC carries
  const uint8_t* hy;   // (B, W)
  const uint8_t* hu;   // (B, W/2)
  const uint8_t* hv;
  const int16_t* hdt;  // (B, mw, 4)
};

// Sum over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(vp8::kFullMask, v, o);
  return v;
}

// The first of the 4 modes with the least cost (the costs stay in
// registers: nothing indexes them at run time).
__device__ __forceinline__ int argmin4(const int* c) {
  int m = 0, best = c[0];
#pragma unroll
  for (int i = 1; i < 4; i++)
    if (c[i] < best) {
      best = c[i];
      m = i;
    }
  return m;
}

// 4 blocks an SM: the dynamic tables (41,472 bytes) and the static state
// fit 4 times in an SM's shared memory (3 times in the trellis form).
template <bool kI4, bool kTrellis, bool kStripe = false>
__global__ void __launch_bounds__(kThreads, 4) wavefront_search_kernel(Args a) {
  constexpr bool kTables = kI4 || kTrellis;
  extern __shared__ __align__(16) unsigned char s_tables[];  // Tables[3], or [4] (kTrellis)
  __shared__ int sy[17 * kSW];     // luma: row 0 [tl, top16, tr4], col 0 left16, recon
  __shared__ int sc[2][9 * kCW];   // U, V: row 0 [tl, top8], col 0 left8, recon
  __shared__ __align__(16) uint8_t ss[256], scs[2][64];  // the MB's source pixels
  __shared__ int s_dc[16], s_im[16];  // the i16 DCs, the walk's B-modes
  __shared__ int s_q[24], s_iq[24], s_pen[4];  // the image's per-segment rows
  __shared__ int4 s_pent[160];  // pred_lane_entry(m, k) at 16 * m + k
  __shared__ int s_sse[2][4], s_d16[2];  // per luma warp: i16 mode SSEs, d16
  __shared__ int s_s16, s_s4[2], s_is4, s_ymode, s_uvmode, s_seg, s_row;
  // the MB's levels (luma 0-255, chroma 256-383, Y2 384-399), written out
  // after the hand-over; the walk's winners' levels apart (an MB that
  // keeps i16 writes out the luma levels of s_lv)
  __shared__ __align__(16) int16_t s_lv[400];
  __shared__ __align__(16) int16_t s_l4[256];
  // the trellis form: each table's zero-run sums (i4_lanes.cuh
  // trellis_lanes' zrun, table i at 16 * i) and the per-segment lambdas
  constexpr int kT = kTrellis ? 1 : 0;
  __shared__ int s_zrun[kT ? 64 : 1], s_lam[4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = lane & 15, half = lane >> 4;
  const int kr = k >> 2, kc = k & 3;
  const int mh = a.mh, mw = a.mw;
  const int W = 16 * mw, H = 16 * mh, Wc = 8 * mw, Hc = 8 * mh;
  if constexpr (kI4)
    for (int i = tid; i < 160; i += kThreads) s_pent[i] = vp8::pred_lane_entry(i >> 4, i & 15);
  if constexpr (kTables) {
    vp8::Tables* tw = reinterpret_cast<vp8::Tables*>(s_tables);
    for (int i = 0; i < 3 + kT; i++)
      vp8::stage_tables(tw[i], a.p0 + 96 * i, a.p1 + 96 * i, a.val + vp8::kVal * i);
  }
  if constexpr (kTrellis)
    for (int i = tid; i < 64; i += kThreads) {  // sums of p1[3 m][0] (pp.z), m < n
      int z = 0;
      for (int m = 0; m < (i & 15); m++) z += a.p1[96 * (i >> 4) + 6 * m];
      s_zrun[i] = z;
    }

  for (;;) {
    __syncthreads();  // the last row's shared state is no longer read
    if (tid == 0) s_row = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = s_row;  // tickets go row by row across the batch
    if (t >= a.B * mh) return;
    const int my = t / a.B, b = t - my * a.B;
    const int row = b * mh + my;
    const bool ht = kStripe || my > 0;  // the stripe form: row 0 has the halo above
    const bool from_halo = kStripe && my == 0;
    const uint8_t* ysrc = a.y + (size_t)b * H * W;
    uint8_t* yrec = a.ry + (size_t)b * H * W;
    const int y0 = 16 * my, cy0 = 8 * my;
    if (tid < 24) {
      const int q = a.qsteps[(size_t)b * 24 + tid];
      s_q[tid] = q;
      s_iq[tid] = (1 << 17) / (q > 1 ? q : 1);
    } else if (kI4 && tid < 28) {
      s_pen[tid - 24] = a.pens[(size_t)b * 4 + tid - 24];
    } else if (kTrellis && tid >= 32 && tid < 36) {
      s_lam[tid - 32] = a.lams[(size_t)b * 4 + tid - 32];
    }
    int seen = 0;             // thread 0: row above's last published count
    int dl0 = 0, dl1 = 0;     // warp 1, lane 0 of each segment: carries to the right

    // This thread's share of an MB's own inputs (no other row writes
    // them), fetched one MB ahead so that their latency is off the chain.
    auto fetch = [&](int mx) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (tid < 16) {
        w = __ldg(reinterpret_cast<const uint4*>(ysrc + (size_t)(y0 + tid) * W + 16 * mx));
      } else if (tid < 32) {
        const uint8_t* cs = (tid < 24 ? a.u : a.v) + (size_t)b * Hc * Wc;
        const uint2 c = __ldg(
            reinterpret_cast<const uint2*>(cs + (size_t)(cy0 + (tid & 7)) * Wc + 8 * mx));
        w.x = c.x;
        w.y = c.y;
      } else if (tid == 48) {
        w.x = a.seg[(size_t)row * mw + mx];
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
        } else if (tid == 48) {
          s_seg = (int)next.x;
        }
        if (mx + 1 < mw) next = fetch(mx + 1);
      }
      // ---- wait for the row above ----
      if (tid == 0 && my > 0) {
        const int need = min(mx + 2, mw);
        for (unsigned spins = 0; seen < need; spins++) {
          seen = vp8::ld_acquire(a.progress + row - 1);
          // A wait of seconds means a broken hand-over: fail the launch
          // with an error instead of hanging the card.
          if (spins == (1u << 24)) __trap();
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
          top = __ldcg((from_halo ? a.hy + (size_t)b * W : yrec + (size_t)(y0 - 1) * W) + col);
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
          const uint8_t* crec = from_halo ? (half ? a.hv : a.hu) + (size_t)b * Wc
                                          : (half ? a.rv : a.ru) + (size_t)b * Hc * Wc +
                                                (size_t)(cy0 - 1) * Wc;
          top = __ldcg(crec + cx0 + k);
        }
        if (k == 0 && a.use_derr && ht) {
          const int16_t* p = (from_halo ? a.hdt + ((size_t)b * mw + mx) * 4 : a.dtop + (mb - mw) * 4) +
                             2 * half;
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
        vp8::named_barrier_luma();  // warp 0's top context is in sy
        const int sg = s_seg;
        const int* q = s_q + 6 * sg;
        const int* iq = s_iq + 6 * sg;
        const int q0 = q[0], q1 = q[1], iq0 = iq[0], iq1 = iq[1];
        // warp 0 takes sub-blocks 0-7, warp 2 sub-blocks 8-15
        const int blk0 = warp == 0 ? 0 : 8;
        const int dcv = vp8::luma_dc(sy, half, k, ht, hl);
        const int tl = sy[0];
        // ---- i16 mode: the SSE of DC/TM/VE/HE over this lane's 4 pixels ----
        int sse[4] = {0, 0, 0, 0};
#pragma unroll
        for (int rnd = 0; rnd < 4; rnd++) {
          const int blk = blk0 + 2 * rnd + half;
          const int R = 4 * (blk >> 2) + kr, C = 4 * (blk & 3) + kc;
          const int top = sy[1 + C], left = sy[(1 + R) * kSW], s = ss[R * 16 + C];
          const int e0 = s - dcv, e1 = s - vp8::clip8(left + top - tl);
          const int e2 = s - top, e3 = s - left;
          sse[0] += e0 * e0;
          sse[1] += e1 * e1;
          sse[2] += e2 * e2;
          sse[3] += e3 * e3;
        }
#pragma unroll
        for (int i = 0; i < 4; i++) sse[i] = warp_sum(sse[i]);
        if (lane == 0)
#pragma unroll
          for (int i = 0; i < 4; i++) s_sse[warp >> 1][i] = sse[i];
        vp8::named_barrier_luma();  // both warps' SSEs are in s_sse
        int tot[4];
#pragma unroll
        for (int i = 0; i < 4; i++) tot[i] = s_sse[0][i] + s_sse[1][i];
        const int m = argmin4(tot);
        if (tid == 0) s_ymode = m;

        // ---- i16 code with mode m; the recon stays in registers ----
        int x[4], pr[4], rec[4];  // this warp's 4 rounds of 2 sub-blocks, together
        const vp8::Tables* T = reinterpret_cast<const vp8::Tables*>(s_tables);
        const int lam = kTrellis ? s_lam[sg] : 0;
        // the trellis form: each segment refines its 4 AC blocks and, as
        // every segment holds the Y2 block, the Y2 block too, together, in
        // registers; the refined levels replace the quantizer's in s_lv
        // (warp 0's segment 0 stores Y2's)
        auto refine16 = [&](const int* cf, int y2c, int* lvx, int& l2) {
          if constexpr (kTrellis) {
            const vp8::TrellisType ac{0, 1, q0, q1}, ty[5] = {ac, ac, ac, ac, {1, 0, q[2], q[3]}};
            const int c5[5] = {cf[0], cf[1], cf[2], cf[3], y2c};
            int l5[5] = {lvx[0], lvx[1], lvx[2], lvx[3], l2};
            vp8::trellis_lanes<5>(c5, l5, k, lam, ty, T, s_zrun);
#pragma unroll
            for (int rnd = 0; rnd < 4; rnd++) {
              lvx[rnd] = l5[rnd];
              s_lv[16 * (blk0 + 2 * rnd + half) + vp8::inv_zigzag(k)] = (int16_t)l5[rnd];
            }
            l2 = l5[4];
            if (warp == 0 && half == 0) s_lv[384 + vp8::inv_zigzag(k)] = (int16_t)l2;
          }
        };
        vp8::code_i16(warp, half, k, m, dcv, tl, sy, ss, q, iq, q1, iq0, iq1, s_dc, s_lv, x, pr,
                      refine16);
#pragma unroll
        for (int rnd = 0; rnd < 4; rnd++) rec[rnd] = vp8::clip8(pr[rnd] + x[rnd]);

        bool is4 = false;
        if constexpr (kI4) {
          // d16: the SSE of the source against the i16 recon
          int d = 0;
#pragma unroll
          for (int rnd = 0; rnd < 4; rnd++) {
            const int blk = blk0 + 2 * rnd + half;
            const int e = ss[(4 * (blk >> 2) + kr) * 16 + 4 * (blk & 3) + kc] - rec[rnd];
            d += e * e;
          }
          d = warp_sum(d);
          if (lane == 0) s_d16[warp >> 1] = d;
          const int pen = s_pen[sg];
          vp8::named_barrier_luma();  // the i16 and Y2 levels and both d16 halves are in shared
          if (warp == 2) {
            // ---- the i16 rate by position: segment h charges AC blocks
            // 8h .. 8h + 7 (type 0 from position 1), segment 0 also the Y2
            // block (type 1); ctx0 = 1 for every block ----
            int ac[8], y2[1];
            vp8::rate_zigzag<8, 1>(s_lv + 128 * half, k, T[0], ac);
            vp8::rate_zigzag<1, 0>(s_lv + 384, k, T[1], y2);
            int r = half == 0 ? y2[0] : 0;
#pragma unroll
            for (int b = 0; b < 8; b++) r += ac[b];
            r += __shfl_xor_sync(vp8::kFullMask, r, 16);
            if (lane == 0) s_s16 = s_d16[0] + s_d16[1] + vp8::mul_shr16(pen, r);
          }
          // ---- the i4 walk, in sub-block diagonal order d = 2*gy + gx:
          // warp 0 takes sub-block (gy0, d - 2*gy0) of each diagonal, warp
          // 2 (after the i16 rate) sub-block (gy0 + 1, d - 2*gy0 - 2) of
          // the diagonals that hold two; segment `half` scores B-modes
          // 5*half .. 5*half + 4 together ----
          const vp8::Quant qv{iq0, iq1, q0, q1, pen};
          // the trellis form: each segment refines its 5 candidates in
          // registers
          auto refine4 = [&](const int* cf, int* lv) {
            if constexpr (kTrellis) {
              const vp8::TrellisType i4{2, 0, q0, q1}, ty[5] = {i4, i4, i4, i4, i4};
              vp8::trellis_lanes<5>(cf, lv, k, lam, ty, T, s_zrun);
            }
          };
          int s4 = 0;
          for (int dg = 0; dg < 10; dg++) {
            const bool two = dg >= 2 && dg <= 7;  // diagonals holding 2 sub-blocks
            // the steps before see the recon they read: both warps' from
            // diagonal 2 on, warp 0's own before
            if (dg >= 2 && dg <= 8)
              vp8::named_barrier_luma();
            else
              __syncwarp();
            if (warp == 2 && !two) continue;
            const int gy = (dg < 3 ? 0 : (dg - 2) >> 1) + (warp >> 1), gx = dg - 2 * gy;
            const int r = 4 * gy, c = 4 * gx, n = 4 * gy + gx;
            int key[5], crec[5], clv[5];
            vp8::score_lanes<5>(s_pent, 5 * half, k, sy, r * kSW + c, ss[(r + kr) * 16 + c + kc],
                                qv, T[2], key, crec, clv, refine4);
            // the first minimum of (cost, mode) is the least key: the
            // segment's, then the sub-block's over both segments
            const int ks = min(min(min(key[0], key[1]), min(key[2], key[3])), key[4]);
            const int best = min(ks, __shfl_xor_sync(vp8::kFullMask, ks, 16));
            if (ks == best) {  // this segment holds the winner
              int pix = crec[0], lvl = clv[0];
#pragma unroll
              for (int j = 1; j < 5; j++)
                if (key[j] == best) {
                  pix = crec[j];
                  lvl = clv[j];
                }
              sy[(r + 1 + kr) * kSW + c + 1 + kc] = pix;
              s_l4[16 * n + vp8::inv_zigzag(k)] = (int16_t)lvl;
              if (k == 0) s_im[n] = best & 15;
            }
            s4 += best >> 4;
          }
          if (lane == 0) s_s4[warp >> 1] = s4;
          vp8::named_barrier_luma();  // s16, s4, the walk's modes, levels and scratch are in shared
          is4 = s_s4[0] + s_s4[1] < s_s16;
        }
        if (is4) {
          if (warp == 0 && half == 0) s_lv[384 + k] = 0;  // no Y2; the levels are in s_l4
        } else {
#pragma unroll
          for (int rnd = 0; rnd < 4; rnd++) {
            const int blk = blk0 + 2 * rnd + half;
            const int R = 4 * (blk >> 2) + kr, C = 4 * (blk & 3) + kc;
            sy[(1 + R) * kSW + 1 + C] = rec[rnd];
          }
        }
        if (tid == 0) s_is4 = is4;
        vp8::named_barrier_luma();  // the whole MB's recon is in sy
        if (tid == 15) vp8::store_row16(yrec + (size_t)(y0 + 15) * W + x0, sy + 16 * kSW + 1);
      } else {
        // ================= chroma: segment `half` codes channel U or V =================
        const int ch = half;
        int* S = sc[ch];
        int sum = k < 8 ? S[1 + k] : S[(k - 7) * kCW];  // top8, then left8
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(vp8::kFullMask, sum, o);
        const int dcv = vp8::dc_whole(vp8::seg_get(sum, 0), vp8::seg_get(sum, 8), ht, hl, 8);
        const int tl = S[0];
        // ---- uv mode: the SSE of U and V together over the 4 modes ----
        int sse[4] = {0, 0, 0, 0};
#pragma unroll
        for (int blk = 0; blk < 4; blk++) {
          const int R = 4 * (blk >> 1) + kr, C = 4 * (blk & 1) + kc;
          const int top = S[1 + C], left = S[(1 + R) * kCW], s = scs[ch][R * 8 + C];
          const int e0 = s - dcv, e1 = s - vp8::clip8(left + top - tl);
          const int e2 = s - top, e3 = s - left;
          sse[0] += e0 * e0;
          sse[1] += e1 * e1;
          sse[2] += e2 * e2;
          sse[3] += e3 * e3;
        }
#pragma unroll
        for (int i = 0; i < 4; i++) sse[i] = warp_sum(sse[i]);
        const int m = argmin4(sse);
        if (lane == 0) s_uvmode = m;
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
        int lv[4];
#pragma unroll
        for (int blk = 0; blk < 4; blk++)
          lv[blk] = vp8::quant_lane(cfr[blk], k, iq[4], iq[5], vp8::kBiasUvDc, vp8::kBiasUvAc,
                                    false);
        if constexpr (kTrellis) {  // the segment refines its channel's 4 blocks
          const vp8::TrellisType uvt{3, 0, q[4], q[5]}, ty[4] = {uvt, uvt, uvt, uvt};
          vp8::trellis_lanes<4>(cfr, lv, k, s_lam[s_seg], ty,
                                reinterpret_cast<const vp8::Tables*>(s_tables), s_zrun);
        }
#pragma unroll
        for (int blk = 0; blk < 4; blk++) uv[blk * 16 + vp8::inv_zigzag(k)] = (int16_t)lv[blk];
#pragma unroll
        for (int blk = 0; blk < 4; blk++) cfr[blk] = lv[blk] * (k == 0 ? q[4] : q[5]);
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
      if (tid == 64) vp8::st_release(a.progress + row, mx + 1);  // off warps 0-1's path

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
        reinterpret_cast<uint4*>(a.ylv + mb * 256)[tid - 64] =
            reinterpret_cast<const uint4*>(kI4 && s_is4 ? s_l4 : s_lv)[tid - 64];
      else if (tid >= 32 && tid < 48)
        reinterpret_cast<uint4*>(a.uvlv + mb * 128)[tid - 32] = lv4[tid];
      else if (tid >= 48 && tid < 50)
        reinterpret_cast<uint4*>(a.y2lv + mb * 16)[tid - 48] = lv4[tid];
      else if (tid == 50) {
        // imodes: the walk's B-modes for an i4 MB, else ymode repeated
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; i++) {
          w[i] = 0;
#pragma unroll
          for (int j = 0; j < 4; j++)
            w[i] |= (unsigned)(s_is4 ? s_im[4 * i + j] : s_ymode) << (8 * j);
        }
        *reinterpret_cast<uint4*>(a.imodes + mb * 16) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if (tid == 51) {
        a.ymode[mb] = (uint8_t)s_ymode;
        a.uvmode[mb] = (uint8_t)s_uvmode;
        a.is_i4[mb] = (uint8_t)s_is4;
      }
    }
  }
}

// The card's SMs and the blocks an SM holds at once at the launch's
// shared memory and thread count (cached): every block of the ticket grid
// must be resident, or a row could wait on a block that never runs.
template <bool kI4, bool kTrellis, bool kStripe = false>
cudaError_t occupancy(int* sms_out, int* per_sm_out) {
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    const int smem = table_bytes(kI4, kTrellis);
    int dev = 0, n = 0, p = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    // raise the dynamic limit first: the occupancy, and so the ticket
    // grid, must be that of the launch's shared memory
    cudaFuncSetAttribute(wavefront_search_kernel<kI4, kTrellis, kStripe>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p, wavefront_search_kernel<kI4, kTrellis, kStripe>, kThreads, smem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sms = n;
    per_sm = p;
  }
  *sms_out = sms;
  *per_sm_out = per_sm;
  return cudaSuccess;
}

template <bool kI4, bool kTrellis, bool kStripe = false>
int launch(const Args& a, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = occupancy<kI4, kTrellis, kStripe>(&sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int rows = a.B * a.mh;
  const int grid = rows < resident ? rows : resident;
  wavefront_search_kernel<kI4, kTrellis, kStripe>
      <<<grid, kThreads, table_bytes(kI4, kTrellis), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Runs the exact engine's whole wavefront as one launch on `stream`.
// `sync` holds B*mh progress counters and the ticket, all zero.  `form`:
// bit 0 try_i4, bit 1 the trellis form.  pens are read only with try_i4,
// lams only in the trellis form, the rate tables p0/p1/val (3 types, 4 in
// the trellis form) only in either (else they may be null).  hy non-null
// runs the stripe form (not with the trellis): hy (B, 16 mw), hu and hv
// (B, 8 mw) the stripe above's last recon rows, hdt (B, mw, 4) its last MB
// row's UV DC carries (read only with use_derr); the frame's top stripe
// passes all four null.  Returns the CUDA error of the launch (0 =
// accepted).
extern "C" int wavefront_search_launch(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, const int* seg, const int* qsteps,
    const int* pens, const int* p0, const int* p1, const int* val, const int* lams, uint8_t* ry,
    uint8_t* ru, uint8_t* rv, int16_t* dtop, int16_t* ylv, int16_t* y2lv, int16_t* uvlv,
    uint8_t* ymode, uint8_t* uvmode, uint8_t* is_i4, uint8_t* imodes, int* sync, int B, int mh,
    int mw, int use_derr, int form, const uint8_t* hy, const uint8_t* hu, const uint8_t* hv,
    const int16_t* hdt, void* stream) {
  const int rows = B * mh;
  if (rows <= 0 || mw <= 0) return 0;
  const Args a{y,    u,    v,    seg,    qsteps, pens,  p0,     p1,   val,  lams,
               ry,   ru,   rv,   dtop,   ylv,    y2lv,  uvlv,   ymode, uvmode,
               is_i4, imodes, sync, sync + rows, B, mh, mw, use_derr,
               hy,   hu,   hv,   hdt};
  const cudaStream_t st = (cudaStream_t)stream;
  if (hy) {
    if (form & 2) return (int)cudaErrorInvalidValue;
    return form & 1 ? launch<true, false, true>(a, st) : launch<false, false, true>(a, st);
  }
  switch (form & 3) {
    case 0: return launch<false, false>(a, st);
    case 1: return launch<true, false>(a, st);
    case 2: return launch<false, true>(a, st);
    default: return launch<true, true>(a, st);
  }
}

// The launch's residency: the card's SMs and the blocks an SM holds at
// once (the ticket grid is their product, or the rows if fewer).  Returns
// the CUDA error (0 = ok).
extern "C" int wavefront_search_occupancy(int try_i4, int trellis, int* sms, int* per_sm) {
  const int form = (try_i4 ? 1 : 0) | (trellis ? 2 : 0);
  return (int)(form == 0   ? occupancy<false, false>(sms, per_sm)
               : form == 1 ? occupancy<true, false>(sms, per_sm)
               : form == 2 ? occupancy<false, true>(sms, per_sm)
                           : occupancy<true, true>(sms, per_sm));
}
