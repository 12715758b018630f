// i4 candidate search: score all 10 B-modes of a 4x4 luma sub-block and
// keep the RD argmin — the hybrid encoder's refine round.
//
// Two kernels over one device body (search_group):
// - i4_search_kernel replaces the TPU kernel
//   gowebp_tpu/ops/pallas/i4_search.py (i4_search_pallas -> _i4_kernel):
//   S independent sub-blocks, each with its context given.
// - i4_walk_kernel runs the refine round's whole 16-substep Gauss-Seidel
//   walk (gowebp_tpu/ops/encode_wavefront_jax.py, the fori_loop over
//   `sub`) in one launch: each substep's winning recon is the context of
//   the sub-blocks after it, in the MB's (17, 21) scratch border (row 0 =
//   [tl, top16, tr4], column 0 = left16), which stays in shared memory.
//
// Per candidate: predict (the 8 shift-composable modes by selects over
// literal feature indices), FDCT, quantize + zigzag, the exact type-3
// token-grammar rate, dequantize + IDCT, SSE, and
// cost = dist + (pen * (rate + mode_bits)) >> 16 with split limbs.
//
// Bound on the card: integer operations (10 candidates x ~650 int ops per
// sub-block against ~160 bytes of traffic).  The design feeds the integer
// pipes:
// - One lane per candidate: a warp scores 3 sub-blocks at once in groups
//   of 10 lanes (lanes 30-31 mirror lane 29 and store nothing).  The
//   winner is a shuffle argmin over the group that keeps the lowest mode
//   on ties (strict <), and the winner's lane writes its 16 recon pixels.
// - Nothing indexes a register array at run time (the rate walk finds the
//   last nonzero level from a bit mask and walks with predicated adds), so
//   no candidate state goes to local memory.
// - The type-3 rate tables (16 positions x 3 contexts: p0, p1 and 68 value
//   costs, 13,824 bytes) are staged once per block in shared memory; the
//   blocks are persistent, so the tables are read once per resident block.
// - The walk runs the 16 substeps in sub-block diagonal order
//   d = 2*gy + gx: 10 steps of up to 2 sub-blocks per MB (a sub-block reads
//   only its left, top, top-left and top-right neighbours, or the MB's
//   top-right pixels when gx = 3, all on earlier diagonals, so every mode,
//   cost and pixel equals the raster walk's).  A block carries 6 MBs: 12
//   sub-blocks on the 2-wide diagonals fill its 12 groups.
//
// `topk` (gowebp_tpu/ops/encode_wavefront_jax.py _i4_candidates): with k
// in 1..10, each lane first predicts its mode and takes the prediction's
// SSE against the source; a shuffle pass over the group ranks the 10 SSEs
// (ties to the lower mode) and only the k best lanes run the FDCT,
// quantization, rate and cost.  The argmin then keeps the first minimum
// in rank order.  Both kernels are templates on kRanked, so topk = 0
// (none) compiles to the unranked code above, unchanged.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "i4_score.cuh"
#include "vp8_dsp.cuh"

namespace {

using vp8::kGroup;
using vp8::Quant;
using vp8::search_group;
using vp8::stage_tables;
using vp8::Tables;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;           // blocks per SM: <= 128 registers, no spills
constexpr int kSlots = 3 * kWarps;      // sub-blocks a block scores at once
constexpr int kWalkMBs = kSlots / 2;    // MBs a walk block carries
constexpr int kSW = 21;                 // walk scratch row: [tl, top16, tr4]

__device__ __forceinline__ void store_rec16(uint8_t* out, const int* rec) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; i++)
    w[i] = (unsigned)rec[4 * i] | ((unsigned)rec[4 * i + 1] << 8) |
           ((unsigned)rec[4 * i + 2] << 16) | ((unsigned)rec[4 * i + 3] << 24);
  *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kRanked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
i4_search_kernel(const int* __restrict__ ctx13, const int* __restrict__ src16,
                 const int* __restrict__ quants5, const int* __restrict__ p0n,
                 const int* __restrict__ p1n, const int* __restrict__ valn, int S,
                 int topk, int* __restrict__ bmode, int* __restrict__ bcost,
                 uint8_t* __restrict__ brec) {
  __shared__ Tables t;
  stage_tables(t, p0n, p1n, valn);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = min(lane / kGroup, 2), m = min(lane - kGroup * g, 9);
  const long long stride = (long long)gridDim.x * kSlots;
  for (long long s0 = ((long long)blockIdx.x * kWarps + warp) * 3; s0 < S; s0 += stride) {
    const long long s = s0 + g;
    const bool live = lane < 3 * kGroup && s < S;
    const long long sc = s < S ? s : S - 1;
    const int* cx = ctx13 + sc * 13;  // tl, top0-3, tr0-3, left0-3
    int top[4], tr[4], left[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      top[i] = cx[1 + i];
      tr[i] = cx[5 + i];
      left[i] = cx[9 + i];
    }
    const int* qp = quants5 + sc * 5;  // iq_dc, iq_ac, q_dc, q_ac, pen
    const Quant q{qp[0], qp[1], qp[2], qp[3], qp[4]};
    int rec[16], bc;
    const int bm = search_group<kRanked>(m, kGroup * g, cx[0], top, tr, left, src16 + sc * 16,
                                         4, q, t, topk, rec, &bc);
    if (live && m == bm) {
      bmode[s] = bm;
      bcost[s] = bc;
      store_rec16(brec + s * 16, rec);
    }
  }
}

template <bool kRanked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
i4_walk_kernel(const int* __restrict__ src, const int* __restrict__ top16,
               const int* __restrict__ tr4, const int* __restrict__ left16,
               const int* __restrict__ tlpx, const int* __restrict__ qlane,
               const int* __restrict__ iqlane, const int* __restrict__ pen,
               const int* __restrict__ p0n, const int* __restrict__ p1n,
               const int* __restrict__ valn, int M, int topk, int* __restrict__ bmodes,
               int* __restrict__ s4, uint8_t* __restrict__ rec_out) {
  __shared__ Tables t;
  __shared__ int scr[kWalkMBs][17 * kSW];
  __shared__ int ssrc[kWalkMBs][256];
  __shared__ int sq[kWalkMBs][5];
  __shared__ int ss4[kWalkMBs];
  stage_tables(t, p0n, p1n, valn);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = min(lane / kGroup, 2), m = min(lane - kGroup * g, 9);
  const int slot = 3 * warp + g;
  for (long long mb0 = (long long)blockIdx.x * kWalkMBs; mb0 < M;
       mb0 += (long long)gridDim.x * kWalkMBs) {
    __syncthreads();  // the last group's scratch is no longer read
    for (int i = tid; i < kWalkMBs * 256; i += kThreads) {
      const int j = i >> 8;
      const long long mb = min(mb0 + j, (long long)M - 1);
      ssrc[j][i & 255] = src[mb * 256 + (i & 255)];
    }
    for (int i = tid; i < kWalkMBs * 37; i += kThreads) {
      const int j = i / 37, e = i - 37 * j;  // tl, top16, tr4, left16
      const long long mb = min(mb0 + j, (long long)M - 1);
      if (e == 0) scr[j][0] = tlpx[mb];
      else if (e <= 16) scr[j][e] = top16[mb * 16 + e - 1];
      else if (e <= 20) scr[j][e] = tr4[mb * 4 + e - 17];
      else scr[j][(e - 20) * kSW] = left16[mb * 16 + e - 21];
    }
    if (tid < kWalkMBs * 5) {
      const int j = tid / 5, e = tid - 5 * j;
      const long long mb = min(mb0 + j, (long long)M - 1);
      sq[j][e] = e < 2 ? iqlane[mb * 6 + e] : e < 4 ? qlane[mb * 6 + e - 2] : pen[mb];
    }
    if (tid < kWalkMBs) ss4[tid] = 0;
    __syncthreads();

    for (int d = 0; d < 10; d++) {
      const bool two = d >= 2 && d <= 7;  // diagonals holding 2 sub-blocks
      const int j0 = two ? slot >> 1 : slot;
      const bool live = lane < 3 * kGroup && j0 < kWalkMBs && mb0 + j0 < M;
      if (__any_sync(vp8::kFullMask, live)) {
        const int j = live ? j0 : 0;
        const int gy = (d < 3 ? 0 : (d - 2) >> 1) + (two ? slot & 1 : 0), gx = d - 2 * gy;
        const int r = 4 * gy, c = 4 * gx;
        const int* S = scr[j];
        int top[4], tr[4], left[4];
#pragma unroll
        for (int i = 0; i < 4; i++) {
          top[i] = S[r * kSW + c + 1 + i];
          tr[i] = gx == 3 ? S[17 + i] : S[r * kSW + c + 5 + i];
          left[i] = S[(r + 1 + i) * kSW + c];
        }
        const Quant q{sq[j][0], sq[j][1], sq[j][2], sq[j][3], sq[j][4]};
        int rec[16], bc;
        const int bm = search_group<kRanked>(m, kGroup * g, S[r * kSW + c], top, tr, left,
                                             ssrc[j] + r * 16 + c, 16, q, t, topk, rec, &bc);
        if (live && m == bm) {
          int* out = scr[j] + (r + 1) * kSW + c + 1;
#pragma unroll
          for (int k = 0; k < 16; k++) out[(k >> 2) * kSW + (k & 3)] = rec[k];
          bmodes[(mb0 + j) * 16 + 4 * gy + gx] = bm;
          atomicAdd(&ss4[j], bc);  // integer sum: order-free
        }
      }
      __syncthreads();
    }
    if (tid < kWalkMBs && mb0 + tid < M) s4[mb0 + tid] = ss4[tid];
    if (rec_out != nullptr)
      for (int i = tid; i < kWalkMBs * 256; i += kThreads) {
        const int j = i >> 8, e = i & 255;
        if (mb0 + j < M)
          rec_out[(mb0 + j) * 256 + e] = (uint8_t)scr[j][(1 + (e >> 4)) * kSW + 1 + (e & 15)];
      }
  }
}

// Blocks of `kernel` that the card holds at once (at least 1).
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <bool kRanked>
int launch_search(const int* ctx13, const int* src16, const int* quants5, const int* p0n,
                  const int* p1n, const int* valn, int S, int topk, int* bmode, int* bcost,
                  uint8_t* brec, cudaStream_t stream) {
  static const int resident = resident_blocks((const void*)i4_search_kernel<kRanked>);
  const int need = (S + kSlots - 1) / kSlots;
  i4_search_kernel<kRanked><<<need < resident ? need : resident, kThreads, 0, stream>>>(
      ctx13, src16, quants5, p0n, p1n, valn, S, topk, bmode, bcost, brec);
  return (int)cudaGetLastError();
}

template <bool kRanked>
int launch_walk(const int* src, const int* top16, const int* tr4, const int* left16,
                const int* tl, const int* qlane, const int* iqlane, const int* pen,
                const int* p0n, const int* p1n, const int* valn, int M, int topk, int* bmodes,
                int* s4, uint8_t* rec, cudaStream_t stream) {
  static const int resident = resident_blocks((const void*)i4_walk_kernel<kRanked>);
  const int need = (M + kWalkMBs - 1) / kWalkMBs;
  i4_walk_kernel<kRanked><<<need < resident ? need : resident, kThreads, 0, stream>>>(
      src, top16, tr4, left16, tl, qlane, iqlane, pen, p0n, p1n, valn, M, topk, bmodes, s4,
      rec);
  return (int)cudaGetLastError();
}

}  // namespace

// S independent sub-blocks; topk 0 scores all 10 modes, 1..10 the k best-predicting.
extern "C" int i4_search_launch(const int* ctx13, const int* src16, const int* quants5,
                                const int* p0n, const int* p1n, const int* valn, int S,
                                int topk, int* bmode, int* bcost, uint8_t* brec, void* stream) {
  if (S <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return topk > 0 ? launch_search<true>(ctx13, src16, quants5, p0n, p1n, valn, S, topk, bmode,
                                        bcost, brec, st)
                  : launch_search<false>(ctx13, src16, quants5, p0n, p1n, valn, S, 0, bmode,
                                         bcost, brec, st);
}

// The refine round's walk over M MBs; `rec` (M, 256) may be null; topk as above.
extern "C" int i4_walk_launch(const int* src, const int* top16, const int* tr4,
                              const int* left16, const int* tl, const int* qlane,
                              const int* iqlane, const int* pen, const int* p0n,
                              const int* p1n, const int* valn, int M, int topk, int* bmodes,
                              int* s4, uint8_t* rec, void* stream) {
  if (M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return topk > 0 ? launch_walk<true>(src, top16, tr4, left16, tl, qlane, iqlane, pen, p0n,
                                      p1n, valn, M, topk, bmodes, s4, rec, st)
                  : launch_walk<false>(src, top16, tr4, left16, tl, qlane, iqlane, pen, p0n,
                                       p1n, valn, M, 0, bmodes, s4, rec, st);
}
