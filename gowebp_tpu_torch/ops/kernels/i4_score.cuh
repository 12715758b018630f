// The i4 candidate search's device body, shared by i4_search.cu (the flat
// search and the refine walk) and wavefront_search.cu (the exact engine's
// in-loop walk): the staged rate tables, the exact token-grammar rate
// walk, one candidate's RD score and a 10-lane group's search.

#pragma once
#include <climits>
#include <cstdint>

#include "vp8_dsp.cuh"

namespace vp8 {

constexpr int kGroup = 10;  // lanes per sub-block: one per mode
constexpr int kVal = 16 * 3 * 68;

// pp[row] = (p0[row][0], p0[row][1], p1[row][0], p1[row][1]) for row =
// 3 * position + context: one 16-byte load per position of the rate walk.
struct Tables {
  int4 pp[48];
  int val[kVal];
};

struct Quant {
  int iq_dc, iq_ac, q_dc, q_ac, pen;
};

__device__ __forceinline__ void stage_tables(Tables& t, const int* p0n, const int* p1n,
                                             const int* valn) {
  for (int i = threadIdx.x; i < 48; i += blockDim.x)
    t.pp[i] = make_int4(p0n[2 * i], p0n[2 * i + 1], p1n[2 * i], p1n[2 * i + 1]);
  for (int i = threadIdx.x; i < kVal; i += blockDim.x) t.val[i] = valn[i];
}

// Token rate (1/256 bit) of zigzag levels lv[kFirst..15] with ctx0 = 1,
// on position-indexed tables p0/p1 [16][3][2], val [16][3][68] of one
// token type; lv may sit in registers (int) or in shared memory (int16).
template <int kFirst, typename L>
__device__ __forceinline__ int rate_walk(const L* lv, const Tables& t) {
  unsigned nz_mask = 0;
#pragma unroll
  for (int n = kFirst; n < 16; n++) nz_mask |= (unsigned)(lv[n] != 0) << n;
  const int last = 31 - __clz(nz_mask);  // -1 for an empty block
  int r = 0, prev_v = 0;
  bool prev_nz = false;
  // Unrolled, so lv is indexed by constants; the walk stops after `last`.
#pragma unroll
  for (int n = kFirst; n < 16; n++) {
    if (n > last) break;
    const int a = lv[n] < 0 ? -lv[n] : lv[n];
    const int v = a > 67 ? 67 : a;
    const bool nz = lv[n] != 0;
    const int ctx = n == kFirst ? 1 : (prev_nz ? (prev_v == 1 ? 1 : 2) : 0);
    const int row = n * 3 + ctx;
    const int4 pp = t.pp[row];
    if (n == kFirst || prev_nz) r += pp.y;
    r += nz ? pp.w + t.val[row * 68 + v] + 256 : pp.z;
    prev_nz = nz;
    prev_v = v;
  }
  if (last < 0) return r + t.pp[kFirst * 3 + 1].x;
  if (last == 15) return r;
  const int ctx = prev_v == 1 ? 1 : 2;  // position last+1 follows a nonzero
  return r + t.pp[(last + 1) * 3 + ctx].x;
}

// Type 3 (i4 luma): first = 0.
__device__ __forceinline__ int rate_t3(const int* lv, const Tables& t) {
  return rate_walk<0>(lv, t);
}

// RD cost of mode m, predicted as pred, on one sub-block whose source
// pixel (r, c) is src[r * stride + c]; rec gets its 16 recon pixels.
template <typename Src>
__device__ __forceinline__ int score_pred(int m, const int* pred, const Src* src, int stride,
                                          const Quant& q, const Tables& t, int* rec) {
  int res[16], cf[16], lv[16];
#pragma unroll
  for (int k = 0; k < 16; k++) res[k] = src[(k >> 2) * stride + (k & 3)] - pred[k];
  vp8::fdct4x4(res, cf);
  vp8::quantize(cf, q.iq_dc, q.iq_ac, vp8::kBiasY1Dc, vp8::kBiasY1Ac, false, lv);
  const int rate = rate_t3(lv, t);
  vp8::dequantize(lv, q.q_dc, q.q_ac, cf);
  vp8::idct4x4(cf, res);
  int dist = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    rec[k] = vp8::clip8(pred[k] + res[k]);
    const int d = src[(k >> 2) * stride + (k & 3)] - rec[k];
    dist += d * d;
  }
  return dist + vp8::mul_shr16(q.pen, rate + vp8::kMode4Bits256[m]);
}

// First minimum of the costs of lanes base..base+9 (mode = lane - base).
__device__ __forceinline__ int group_argmin(int cost, int base, int* best_cost) {
  int bc = INT_MAX, bm = 0;
#pragma unroll
  for (int j = 0; j < kGroup; j++) {
    const int cj = __shfl_sync(vp8::kFullMask, cost, base + j);
    if (cj < bc) {
      bc = cj;
      bm = j;
    }
  }
  *best_cost = bc;
  return bm;
}

// Rank of this lane's mode m among lanes base..base+9 by prediction SSE,
// ties to the lower mode.
__device__ __forceinline__ int group_rank(int sse, int m, int base) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < kGroup; j++) {
    const int sj = __shfl_sync(vp8::kFullMask, sse, base + j);
    rank += sj < sse || (sj == sse && j < m);
  }
  return rank;
}

// First minimum of the costs of the lanes ranked below topk, in rank order.
__device__ __forceinline__ int group_argmin_ranked(int cost, int rank, int topk, int base,
                                                   int* best_cost) {
  int bc = INT_MAX, br = kGroup, bm = 0;
#pragma unroll
  for (int j = 0; j < kGroup; j++) {
    const int cj = __shfl_sync(vp8::kFullMask, cost, base + j);
    const int rj = __shfl_sync(vp8::kFullMask, rank, base + j);
    if (rj < topk && (cj < bc || (cj == bc && rj < br))) {
      bc = cj;
      br = rj;
      bm = j;
    }
  }
  *best_cost = bc;
  return bm;
}

// One group's search: lane mode m scores its candidate (kRanked: only if
// it ranks below topk); returns the winning mode and its cost in *bc, and
// leaves the winner's recon in its lane's rec.  All 32 lanes call it.
template <bool kRanked, typename Src>
__device__ __forceinline__ int search_group(int m, int base, int tl, const int* top,
                                            const int* tr, const int* left, const Src* src,
                                            int stride, const Quant& q, const Tables& t,
                                            int topk, int* rec, int* bc) {
  int pred[16];
  vp8::pred_b4_sel(m, tl, top, tr, left, pred);
  if constexpr (!kRanked) {
    return group_argmin(score_pred(m, pred, src, stride, q, t, rec), base, bc);
  }
  int sse = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const int d = src[(k >> 2) * stride + (k & 3)] - pred[k];
    sse += d * d;
  }
  const int rank = group_rank(sse, m, base);
  const int cost = rank < topk ? score_pred(m, pred, src, stride, q, t, rec) : INT_MAX;
  return group_argmin_ranked(cost, rank, topk, base, bc);
}

}  // namespace vp8
