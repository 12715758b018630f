// Macroblock-wavefront pieces shared by the persistent wavefront kernels
// (wavefront_fixed.cu, wavefront_search.cu): the row hand-over, the UV DC
// error-diffusion chain, the lane-parallel B-mode predictions from the
// MB's (17, 21) scratch border, the packed recon-row stores, and the i16
// code of an MB step on the luma warps (warp 0 sub-blocks 0-7, warp 2
// sub-blocks 8-15, each as 4 rounds of 2 on its two 16-lane segments).

#pragma once
#include <cstdint>

#include "vp8_dsp.cuh"

namespace vp8 {

constexpr int kSW = 21;  // luma scratch row: [tl, top16, tr4]
constexpr int kCW = 9;   // chroma scratch row: [tl, top8]

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Barrier of the two luma warps (0 and 2) alone.
__device__ __forceinline__ void named_barrier_luma() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

__device__ __forceinline__ void qsingle_chain(int* dc, int dt0, int dt1, int dl0, int dl1,
                                              int iqdc, int qdc, int* nl, int* nt) {
  auto qs = [&](int vv) {
    const int av = vv < 0 ? -vv : vv;
    int lvl = (av * iqdc + vp8::kBiasUvDc) >> 17;
    lvl = lvl > 2047 ? 2047 : lvl;
    const int err = av - lvl * qdc;
    return (vv < 0 ? -err : err) >> 1;
  };
  dc[0] = dc[0] + ((7 * dt0 + 8 * dl0) >> 3);
  const int e0 = qs(dc[0]);
  dc[1] = dc[1] + ((7 * dt1 + 8 * e0) >> 3);
  const int e1 = qs(dc[1]);
  dc[2] = dc[2] + ((7 * e0 + 8 * dl1) >> 3);
  const int e2 = qs(dc[2]);
  dc[3] = dc[3] + ((7 * e1 + 8 * e2) >> 3);
  const int e3 = qs(dc[3]);
  const int lv1 = (3 * e3) >> 2;
  nl[0] = e1;
  nl[1] = lv1;
  nt[0] = e2;
  nt[1] = e3 - lv1;
}

// Scratch offset, from a sub-block's corner (r, c), of feature Z[z]
// (z = 0..14) of its B-mode predictions: Z = [L, L, K, J, I, X, A, B, C,
// D, E, F, G, H, H] (left bottom-up, corner, top, top-right).  The
// top-right pixels sit at (r, c+5..c+8): above-right sub-block recon, or
// for gx = 3 the MB's top-right pixels, which row 0 holds and rows 4, 8
// and 12 repeat in columns 17-20.
__device__ __forceinline__ int z_off(int z) {
  return z <= 4 ? kSW * (1 + min(3, 4 - z)) : (z == 5 ? 0 : min(z, 13) - 5);
}

// Prediction table entry of mode m, pixel k: three feature offsets o0-o2
// (bytes 0-2) and, in byte 3, how they combine: the value is
// clip8((z0 + w1 * z1 + w2 * z2 + sh) >> sh) with w1 (bits 0-1), w2 + 1
// (bits 2-3) and sh (bits 4-5): a copy (1, 0, 0; 0), avg2 (1, 1, 0; 1),
// avg3 (1, 2, 1; 2) or TM (1, 1, -1; 0).  Bit 6 marks DC.
__device__ __forceinline__ unsigned pred_entry(int m, int k) {
  unsigned o0 = 0, o1 = 0, o2 = 0, op = 1u << 6 | 1u << 2;  // DC
  if (m == 1) {
    o0 = kSW * (1 + (k >> 2));  // left of the pixel's row
    o1 = 1 + (k & 3);           // top of its column
    op = 1u;                    // z0 + z1 - z2 (z2 = the corner)
  } else if (m >= 2) {
    const int f = vp8::kB4Features[8 * k + m - 2];  // Z, avg2 (15-28), avg3 (29-41)
    const int i0 = f < 15 ? f : (f < 29 ? f - 15 : f - 29);
    o0 = z_off(i0);
    o1 = z_off(min(i0 + 1, 14));
    o2 = z_off(min(i0 + 2, 14));
    op = f < 15 ? (0u | 1u << 2) : (f < 29 ? (1u | 1u << 2 | 1u << 4) : (2u | 2u << 2 | 2u << 4));
  }
  return o0 | (o1 << 8) | (o2 << 16) | (op << 24);
}

// Lane-parallel B-mode prediction, entry e = pred_entry(mode, k), of
// pixel k of the sub-block whose context corner is scratch index `base`:
// three independent shared-memory reads, no branch on the pixel; only DC
// reads its 8 neighbours instead.
__device__ __forceinline__ int pred_b4_lane(unsigned e, const int* s, int base) {
  const int z0 = s[base + (e & 255)], z1 = s[base + ((e >> 8) & 255)];
  const int z2 = s[base + ((e >> 16) & 255)];
  const int op = e >> 24, sh = (op >> 4) & 3;
  const int v = vp8::clip8((z0 + (op & 3) * z1 + (((op >> 2) & 3) - 1) * z2 + sh) >> sh);
  if (!(op & 64)) return v;
  int dc = 4;  // DC: (top 4 + left 4 + 4) >> 3
#pragma unroll
  for (int i = 0; i < 4; i++) dc += s[base + 1 + i] + s[base + (1 + i) * kSW];
  return dc >> 3;
}

// 16 / 8 scratch ints -> 16 / 8 bytes of a plane row.
__device__ __forceinline__ unsigned pack4(const int* p) {
  return (unsigned)p[0] | ((unsigned)p[1] << 8) | ((unsigned)p[2] << 16) |
         ((unsigned)p[3] << 24);
}
__device__ __forceinline__ void store_row16(uint8_t* out, const int* p) {
  *reinterpret_cast<uint4*>(out) = make_uint4(pack4(p), pack4(p + 4), pack4(p + 8), pack4(p + 12));
}
__device__ __forceinline__ void store_row8(uint8_t* out, const int* p) {
  *reinterpret_cast<uint2*>(out) = make_uint2(pack4(p), pack4(p + 4));
}

// Luma warps: the whole-MB DC prediction (segment 0 sums top16, segment 1
// left16).
__device__ __forceinline__ int luma_dc(const int* sy, int half, int k, bool ht, bool hl) {
  int sum = half == 0 ? sy[1 + k] : sy[(1 + k) * kSW];
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  return dc_whole(__shfl_sync(kFullMask, sum, 0), __shfl_sync(kFullMask, sum, 16), ht, hl, 16);
}

// Luma warps: the i16 code of this warp's 8 sub-blocks with mode m (DC
// value dcv, corner tl): prediction into pr, FDCT, quantization into s_lv
// (the DCs through s_dc, after a barrier of the two luma warps), the Y2
// WHT, quantization (warp 0's segment 0 stores the Y2 levels), IWHT,
// dequantization and IDCT; x ends as each pixel's residual before the
// clip.  q1, iq0, iq1 are q[1], iq[0], iq[1], already in registers.
// refine(cf, y2c, x, l2), called by both warps once the levels are in
// s_lv, may change the levels before the dequantization (this lane's AC
// levels x[4] and Y2 level l2, from its coefficients cf[4] and Y2
// coefficient y2c; it stores what it changes in s_lv itself):
// wavefront_search.cu's trellis form.
template <typename Refine>
__device__ __forceinline__ void code_i16(int warp, int half, int k, int m, int dcv, int tl,
                                         const int* sy, const uint8_t* ss, const int* q,
                                         const int* iq, int q1, int iq0, int iq1, int* s_dc,
                                         int16_t* s_lv, int* x, int* pr, Refine refine) {
  const int kr = k >> 2, kc = k & 3;
  const int blk0 = warp == 0 ? 0 : 8;
#pragma unroll
  for (int rnd = 0; rnd < 4; rnd++) {
    const int blk = blk0 + 2 * rnd + half;
    const int R = 4 * (blk >> 2) + kr, C = 4 * (blk & 3) + kc;
    const int top = sy[1 + C], left = sy[(1 + R) * kSW];
    pr[rnd] = m == 0 ? dcv : m == 1 ? clip8(left + top - tl) : m == 2 ? top : left;
    x[rnd] = ss[R * 16 + C] - pr[rnd];
  }
  fdct_lanes<4>(x, k);
  int cf[4];
#pragma unroll
  for (int rnd = 0; rnd < 4; rnd++) {
    const int blk = blk0 + 2 * rnd + half;
    if (k == 0) s_dc[blk] = x[rnd];
    cf[rnd] = x[rnd];
    x[rnd] = quant_lane(x[rnd], k, iq0, iq1, kBiasY1Dc, kBiasY1Ac, true);
    s_lv[blk * 16 + inv_zigzag(k)] = (int16_t)x[rnd];
  }
  named_barrier_luma();  // all 16 DCs are in s_dc
  // Y2: every segment computes it, warp 0's segment 0 stores
  const int y2c = fwht_lane(s_dc[k], k);
  int l2 = quant_lane(y2c, k, iq[2], iq[3], kBiasY2Dc, kBiasY2Ac, false);
  if (warp == 0 && half == 0) s_lv[384 + inv_zigzag(k)] = (int16_t)l2;
  refine(cf, y2c, x, l2);
  const bool any_ac = seg_ballot(k != 0 && l2 != 0) != 0;
  const int dq2 = l2 * (k == 0 ? q[2] : q[3]);
  const int iw = iwht_lane(dq2, k);
  const int rdc = any_ac ? iw : (seg_get(dq2, 0) + 3) >> 3;
#pragma unroll
  for (int rnd = 0; rnd < 4; rnd++) {
    const int rb = seg_get(rdc, blk0 + 2 * rnd + half);
    x[rnd] = k == 0 ? rb : x[rnd] * q1;
  }
  idct_lanes<4>(x, k);
}

// code_i16 with the quantizer's levels as they are.
__device__ __forceinline__ void code_i16(int warp, int half, int k, int m, int dcv, int tl,
                                         const int* sy, const uint8_t* ss, const int* q,
                                         const int* iq, int q1, int iq0, int iq1, int* s_dc,
                                         int16_t* s_lv, int* x, int* pr) {
  code_i16(warp, half, k, m, dcv, tl, sy, ss, q, iq, q1, iq0, iq1, s_dc, s_lv, x, pr,
           [](const int*, int, int*, int&) {});
}

}  // namespace vp8
