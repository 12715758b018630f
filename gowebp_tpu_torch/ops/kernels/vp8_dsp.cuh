// VP8 4x4 block math shared by the Hopper encode kernels.
//
// Exact int32 arithmetic, bit-identical to ops/dct.py, ops/rate.py and
// ops/vp8_recon.py.  Every `>>` is an arithmetic shift of a signed int
// (never a division).  Products that can leave the int32 range (the
// inverse DCT's 35468 / 20091 multipliers on dequantized values) wrap
// modulo 2^32 explicitly, as int32 tensor math does on the host.

#pragma once
#include <cstdint>

namespace vp8 {

// Zigzag scan: X(n, raster index read at zigzag position n).  Literal
// indices, so the 16 coefficients stay in registers.
#define VP8_ZIGZAG(X)                                                     \
  X(0, 0) X(1, 1) X(2, 4) X(3, 8) X(4, 5) X(5, 2) X(6, 3) X(7, 6) X(8, 9) \
  X(9, 12) X(10, 13) X(11, 10) X(12, 7) X(13, 11) X(14, 14) X(15, 15)

// The 8 shift-composable B-modes (VE, HE, RD, VR, LD, VL, HD, HU): each
// output pixel indexes the 42-entry feature vector [Z | avg2 | avg3]
// (ops/vp8_recon.py _B4_IDX, checked by the CPU tests).  X(k, index of
// pixel k under modes 2..9), every index a literal: a kernel that picks
// among the modes with selects keeps the 42 features in registers (an
// index read from a table would put them in local memory).
#define VP8_B4_PIXELS(X)                    \
  X(0, 34, 32, 33, 20, 35, 21, 19, 18)      \
  X(1, 35, 32, 34, 21, 36, 22, 33, 31)      \
  X(2, 36, 32, 35, 22, 37, 23, 34, 17)      \
  X(3, 37, 32, 36, 23, 38, 24, 35, 30)      \
  X(4, 34, 31, 32, 33, 36, 35, 18, 17)      \
  X(5, 35, 31, 33, 34, 37, 36, 32, 30)      \
  X(6, 36, 31, 34, 35, 38, 37, 19, 16)      \
  X(7, 37, 31, 35, 36, 39, 38, 33, 29)      \
  X(8, 34, 30, 31, 32, 37, 22, 17, 16)      \
  X(9, 35, 30, 32, 20, 38, 23, 31, 29)      \
  X(10, 36, 30, 33, 21, 39, 24, 18, 1)      \
  X(11, 37, 30, 34, 22, 40, 39, 32, 1)      \
  X(12, 34, 29, 30, 31, 38, 36, 16, 1)      \
  X(13, 35, 29, 31, 33, 39, 37, 30, 1)      \
  X(14, 36, 29, 32, 34, 40, 38, 17, 1)      \
  X(15, 37, 29, 33, 35, 41, 40, 31, 1)

// The same rows as a table, feature index of pixel k under mode m at
// 8 * k + m - 2, for kernels that build per-(mode, pixel) entries once.
#define VP8_B4_ROW(k, i2, i3, i4, i5, i6, i7, i8, i9) i2, i3, i4, i5, i6, i7, i8, i9,
__constant__ unsigned char kB4Features[128] = {VP8_B4_PIXELS(VP8_B4_ROW)};
#undef VP8_B4_ROW

// Zigzag position of raster coefficient k, one nibble each: a shift
// instead of a table read, so lanes holding different k read no memory.
constexpr unsigned long long kInvZigzagNibbles = 0xFEA9DB83C7426510ull;
__device__ __forceinline__ int inv_zigzag(int k) {
  return (int)((kInvZigzagNibbles >> (4 * k)) & 15);
}

// 1/256-bit header costs of the 10 key-frame B-modes.
__constant__ int kMode4Bits256[10] = {256, 704, 768, 768, 960,
                                      1024, 960, 1024, 1024, 960};

constexpr int kBiasY1Dc = 96 << 9, kBiasY1Ac = 110 << 9;
constexpr int kBiasY2Dc = 96 << 9, kBiasY2Ac = 96 << 9;
constexpr int kBiasUvDc = 110 << 9, kBiasUvAc = 110 << 9;

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int mul1(int a) { return a + (wmul(a, 20091) >> 16); }
__device__ __forceinline__ int mul2(int a) { return wmul(a, 35468) >> 16; }
__device__ __forceinline__ int clip8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// raster residual (16) -> raster coefficients (16)
__device__ __forceinline__ void fdct4x4(const int* in, int* out) {
  int tmp[16];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int d0 = in[4 * i], d1 = in[4 * i + 1], d2 = in[4 * i + 2], d3 = in[4 * i + 3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[4 * i + 0] = (a0 + a1) * 8;
    tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[4 * i + 2] = (a0 - a1) * 8;
    tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int a0 = tmp[i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[i] - tmp[12 + i];
    out[i] = (a0 + a1 + 7) >> 4;
    out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[8 + i] = (a0 - a1 + 7) >> 4;
    out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

// raster dequantized coefficients (16) -> raster residual (16), pre-clip
__device__ __forceinline__ void idct4x4(const int* d, int* out) {
  int C[16];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const int a = d[i] + d[8 + i], b = d[i] - d[8 + i];
    const int c = mul2(d[4 + i]) - mul1(d[12 + i]);
    const int e = mul1(d[4 + i]) + mul2(d[12 + i]);
    C[i] = a + e;
    C[4 + i] = b + c;
    C[8 + i] = b - c;
    C[12 + i] = a - e;
  }
#pragma unroll
  for (int r = 0; r < 4; r++) {
    const int dc = C[4 * r] + 4;
    const int a = dc + C[4 * r + 2], b = dc - C[4 * r + 2];
    const int c = mul2(C[4 * r + 1]) - mul1(C[4 * r + 3]);
    const int e = mul1(C[4 * r + 1]) + mul2(C[4 * r + 3]);
    out[4 * r + 0] = (a + e) >> 3;
    out[4 * r + 1] = (b + c) >> 3;
    out[4 * r + 2] = (b - c) >> 3;
    out[4 * r + 3] = (a - e) >> 3;
  }
}

// raster coefficients -> zigzag levels (QUANTDIV, clamp 2047)
__device__ __forceinline__ void quantize(const int* cf, int iq_dc, int iq_ac,
                                         int bias_dc, int bias_ac, bool first_ac,
                                         int* lv) {
#define VP8_QUANT(n, r)                                        \
  {                                                            \
    const int v = cf[r];                                       \
    const int av = v < 0 ? -v : v;                             \
    int lvl = (av * ((n) == 0 ? iq_dc : iq_ac) + ((n) == 0 ? bias_dc : bias_ac)) >> 17; \
    lvl = lvl > 2047 ? 2047 : lvl;                             \
    if (first_ac && (n) == 0) lvl = 0;                         \
    lv[n] = v < 0 ? -lvl : lvl;                                \
  }
  VP8_ZIGZAG(VP8_QUANT)
#undef VP8_QUANT
}

// zigzag levels -> raster dequantized coefficients
__device__ __forceinline__ void dequantize(const int* lv, int q_dc, int q_ac, int* deq) {
#define VP8_DEQUANT(n, r) deq[r] = lv[n] * ((n) == 0 ? q_dc : q_ac);
  VP8_ZIGZAG(VP8_DEQUANT)
#undef VP8_DEQUANT
}

// One B-mode prediction of a 4x4 sub-block from its context, the mode
// chosen by selects over literal feature indices: nothing is indexed at
// run time, so every array stays in registers.
__device__ __forceinline__ void pred_b4_sel(int mode, int tl, const int* top, const int* tr,
                                            const int* left, int* pred) {
  int f[42];
  f[0] = left[3];
  f[1] = left[3];
  f[2] = left[2];
  f[3] = left[1];
  f[4] = left[0];
  f[5] = tl;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    f[6 + i] = top[i];
    f[10 + i] = tr[i];
  }
  f[14] = tr[3];
#pragma unroll
  for (int i = 0; i < 14; i++) f[15 + i] = (f[i] + f[i + 1] + 1) >> 1;
#pragma unroll
  for (int i = 0; i < 13; i++) f[29 + i] = (f[i] + 2 * f[i + 1] + f[i + 2] + 2) >> 2;
  const int dc = (top[0] + top[1] + top[2] + top[3] + left[0] + left[1] + left[2] +
                  left[3] + 4) >> 3;
#define VP8_B4_SEL(k, i2, i3, i4, i5, i6, i7, i8, i9)                                    \
  pred[k] = mode == 0   ? dc                                                             \
            : mode == 1 ? clip8(left[(k) >> 2] + top[(k) & 3] - tl)                      \
            : mode == 2 ? f[i2]                                                          \
            : mode == 3 ? f[i3]                                                          \
            : mode == 4 ? f[i4]                                                          \
            : mode == 5 ? f[i5]                                                          \
            : mode == 6 ? f[i6]                                                          \
            : mode == 7 ? f[i7]                                                          \
            : mode == 8 ? f[i8]                                                          \
                        : f[i9];
  VP8_B4_PIXELS(VP8_B4_SEL)
#undef VP8_B4_SEL
}

// ---------------------------------------------------------------------------
// Lane-parallel 4x4 blocks.  A 16-lane segment of a warp holds one block:
// lane k of the segment (k = lane & 15) holds element k in raster order
// (row k >> 2, column k & 3).  The helpers trade values by width-16
// shuffles, so all 32 lanes of the warp call them together; the two
// segments may hold two different blocks.
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int seg_get(int v, int k) {
  return __shfl_sync(kFullMask, v, k, 16);
}

// Bit i set where lane i of this lane's segment passes `p`.
__device__ __forceinline__ unsigned seg_ballot(bool p) {
  return (__ballot_sync(kFullMask, p) >> (threadIdx.x & 16)) & 0xFFFFu;
}

// Residual element k -> raster coefficient k (fdct4x4's two passes), for
// N independent blocks at once, in place: the N blocks' shuffles go out
// back to back.  Each pass computes its lane's output with lane-constant
// multipliers and one select, never a branch on the lane.
template <int N>
__device__ __forceinline__ void fdct_lanes(int* x, int k) {
  const int i = k >> 2, j = k & 3;
  int d[N][4], t[N];
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(x[b], 4 * i + e);
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int a0 = d[b][0] + d[b][3], a1 = d[b][1] + d[b][2];
    const int a2 = d[b][1] - d[b][2], a3 = d[b][0] - d[b][3];
    // row pass, output j: (a0 +- a1) * 8, or (a2 * 2217 + a3 * 5352 + 1812)
    // >> 9 (j = 1) and (a3 * 2217 - a2 * 5352 + 937) >> 9 (j = 3)
    const int even = (a0 + (j < 2 ? a1 : -a1)) * 8;
    const int odd = (a2 * (j == 1 ? 2217 : -5352) + a3 * (j == 1 ? 5352 : 2217) +
                     (j == 1 ? 1812 : 937)) >> 9;
    t[b] = (j & 1) ? odd : even;
  }
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(t[b], 4 * e + j);
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int b0 = d[b][0] + d[b][3], b1 = d[b][1] + d[b][2];
    const int b2 = d[b][1] - d[b][2], b3 = d[b][0] - d[b][3];
    // column pass, output i: (b0 +- b1 + 7) >> 4, or
    // ((b2 * 2217 + b3 * 5352 + 12000) >> 16) + (b3 != 0) (i = 1) and
    // (b3 * 2217 - b2 * 5352 + 51000) >> 16 (i = 3)
    const int even = (b0 + (i < 2 ? b1 : -b1) + 7) >> 4;
    const int odd = ((b2 * (i == 1 ? 2217 : -5352) + b3 * (i == 1 ? 5352 : 2217) +
                      (i == 1 ? 12000 : 51000)) >> 16) + (i == 1 && b3 != 0);
    x[b] = (i & 1) ? odd : even;
  }
}

// Dequantized raster coefficient k -> residual element k, pre-clip
// (idct4x4's two passes), for N independent blocks at once, in place.
template <int N>
__device__ __forceinline__ void idct_lanes(int* x, int k) {
  const int i = k >> 2, j = k & 3;
  int d[N][4], t[N];
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(x[b], 4 * e + j);
#pragma unroll
  for (int b = 0; b < N; b++) {
    // column pass, output i: a + e, b + c, b - c, a - e
    const int a = d[b][0] + d[b][2], bb = d[b][0] - d[b][2];
    const int c = mul2(d[b][1]) - mul1(d[b][3]), e = mul1(d[b][1]) + mul2(d[b][3]);
    t[b] = (i == 0 || i == 3 ? a : bb) + (i == 0 ? e : i == 1 ? c : i == 2 ? -c : -e);
  }
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(t[b], 4 * i + e);
#pragma unroll
  for (int b = 0; b < N; b++) {
    // row pass, output j, rounded: (a + e, b + c, b - c, a - e) >> 3
    const int dc = d[b][0] + 4;
    const int a = dc + d[b][2], bb = dc - d[b][2];
    const int c = mul2(d[b][1]) - mul1(d[b][3]), e = mul1(d[b][1]) + mul2(d[b][3]);
    x[b] = ((j == 0 || j == 3 ? a : bb) + (j == 0 ? e : j == 1 ? c : j == 2 ? -c : -e)) >> 3;
  }
}

// QUANTDIV of raster coefficient k (the DC when k == 0), clamp 2047;
// `first_ac` zeroes the DC level.
__device__ __forceinline__ int quant_lane(int v, int k, int iq_dc, int iq_ac, int bias_dc,
                                          int bias_ac, bool first_ac) {
  const int av = v < 0 ? -v : v;
  int lvl = (av * (k == 0 ? iq_dc : iq_ac) + (k == 0 ? bias_dc : bias_ac)) >> 17;
  lvl = lvl > 2047 ? 2047 : lvl;
  if (first_ac && k == 0) lvl = 0;
  return v < 0 ? -lvl : lvl;
}

// One output of the 4-point Walsh-Hadamard butterfly of vp8's (I)WHT.
__device__ __forceinline__ int wht4(int x0, int x1, int x2, int x3, int o) {
  const int a0 = x0 + x3, a1 = x1 + x2, a2 = x1 - x2, a3 = x0 - x3;
  return o == 0 ? a0 + a1 : o == 1 ? a3 + a2 : o == 2 ? a0 - a1 : a3 - a2;
}

// Y2 forward WHT: lane k holds the DC of sub-block k -> coefficient k.
__device__ __forceinline__ int fwht_lane(int dc, int k) {
  const int i = k >> 2, j = k & 3;
  const int t = wht4(seg_get(dc, 4 * i), seg_get(dc, 4 * i + 1), seg_get(dc, 4 * i + 2),
                     seg_get(dc, 4 * i + 3), j);
  return wht4(seg_get(t, j), seg_get(t, 4 + j), seg_get(t, 8 + j), seg_get(t, 12 + j), i) >> 1;
}

// Y2 inverse WHT: dequantized coefficient k -> the DC of sub-block k.
__device__ __forceinline__ int iwht_lane(int x, int k) {
  const int i = k >> 2, j = k & 3;
  const int t = wht4(seg_get(x, j), seg_get(x, 4 + j), seg_get(x, 8 + j), seg_get(x, 12 + j), i);
  return wht4(seg_get(t, 4 * i) + 3, seg_get(t, 4 * i + 1), seg_get(t, 4 * i + 2),
              seg_get(t, 4 * i + 3), j) >> 3;
}

// Whole-block (16x16 luma / 8x8 chroma) DC value with border variants.
__device__ __forceinline__ int dc_whole(int sum_top, int sum_left, bool ht, bool hl,
                                        int size) {
  const int shift = size == 16 ? 5 : 4;
  if (ht && hl) return (sum_top + sum_left + size) >> shift;
  if (hl) return (sum_left + size / 2) >> (shift - 1);
  if (ht) return (sum_top + size / 2) >> (shift - 1);
  return 0x80;
}

// Exact (lam * rate) >> 16 in int32 for 0 <= lam < 2^19 (split limbs).
__device__ __forceinline__ int mul_shr16(int lam, int rate) {
  const int lh = lam >> 8, ll = lam & 0xFF;
  const int rh = rate >> 16, rl = rate & 0xFFFF;
  return lam * rh + ((lh * rl + ((ll * rl) >> 8)) >> 8);
}

}  // namespace vp8
