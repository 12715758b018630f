// Open-loop macroblock encode: the luma and chroma plane kernels, and
// their modes-only forms.
//
// Replace the TPU kernels of gowebp_tpu/ops/pallas/encode_plane.py:
// encode_luma_kernel replaces _run_luma (_luma_kernel), and
// encode_chroma_kernel replaces _run_chroma (_chroma_kernel).  Same
// integer semantics as ops/encode_plane.py's plain versions.  With
// kCode false the same source is the modes-only form: the mode search
// and the mode stores, no transform and no levels (the hybrid engine's
// cold round, ops/encode_wavefront.py openloop_mode_search).
//
// The halo form (kHalo, a template parameter of the kernels with the
// code; gowebp_tpu/ops/encode_plane_jax.py:242 _plane_context with
// left_halo) encodes one width tile of a plane split over devices
// (gowebp_tpu_torch/parallel/shard.py sharded_encode_plane_step): the MB
// column 0 of a tile that is not the leftmost reads its left column and
// corner from a (B, H) halo, the left neighbour's last source column, and
// has a left neighbour (no 129 fill).  The other forms do not read it.
//
// The engine is open-loop: prediction context comes from the source
// plane, so macroblocks do not depend on one another.  One thread owns
// one 4x4 block: 16 lanes make a luma MB (bx in lane bits 0-1, by in
// bits 2-3), 8 lanes a chroma MB (bx in bit 0, by in bit 1, U or V in
// bit 2).  The grid divides nothing: x runs over strips of MBs along an
// MB row (8 luma or 16 chroma MBs a 128-thread block), y over MB rows,
// z over images.
//
// Loads.  A lane reads its four source rows as four 32-bit words.  Rows
// keep one alignment within an image plane (the width is a multiple of
// 8), so a lane loads the aligned words that enclose its 4 bytes (two a
// row only when the image's base is not 4-byte aligned) and funnel-
// shifts them into place: any base and batch stride work.  The MB's top
// row at the lane's columns comes the same way, the MB's left column at
// its rows and the corner as bytes, with the decoder's edge fills (127
// on the top MB row, corner included; 129 on the left MB column).
//
// Search.  The four mode SSEs are sum(s^2) - 2 sum(s p) + sum(p^2): each
// sum over a row of 4 pixels is one dp4a of packed bytes, the DC, VE and
// HE terms follow from row sums, and the TM prediction is built once a
// row as two 16-bit pairs (offset by 256 so that no half goes negative),
// clamped with max/min.u16x2 and packed back to bytes.  The sums are
// reduced across the MB's lanes with xor shuffles, so every lane picks
// the same mode: DC, TM, VE, HE in that order, first minimum wins
// (strict <).
//
// Code.  The chosen prediction is one packed word a row (3 selects a
// row, no per-pixel chain); the residual, FDCT and quantization run in
// registers, and each lane writes its 16 zigzag levels as int16 straight
// into the per-MB layout the emitter reads (32 contiguous bytes a lane,
// an MB's lanes contiguous).  The luma kernel also runs the Y2 path,
// which the TPU version left to XLA: the WHT of the MB's 16 block DCs by
// segment shuffles (vp8_dsp.cuh fwht_lane), one coefficient a lane, then
// its quantization.
//
// Bound on the card: integer operations (some 37 a pixel with the code,
// 16 for the search alone) against 1 byte read and 2.1 bytes written a
// pixel.  No shared memory and no block-level synchronisation.

#include <cuda_runtime.h>

#include <cstdint>

#include "vp8_dsp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kOnes = 0x01010101u;

// Sum of v over the lanes whose index differs in the bits lo..hi.
__device__ __forceinline__ int xor_sum(int v, int lo, int hi) {
  for (int o = lo; o <= hi; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int dot4(unsigned a, unsigned b, int acc) {
  return (int)__dp4a(a, b, (unsigned)acc);
}

// Byte c of w, zero-extended.
__device__ __forceinline__ int byte_of(unsigned w, int c) {
  return (int)__byte_perm(w, 0u, 0x4440u | (unsigned)c);
}

// Each 16-bit half of x clamped to [lo, hi].
__device__ __forceinline__ unsigned clamp_u16x2(unsigned x, unsigned lo, unsigned hi) {
  unsigned r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(lo));
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(r), "r"(hi));
  return r;
}

// The 4 bytes that start `shift / 8` bytes into the aligned word at w.
__device__ __forceinline__ unsigned load4(const uint8_t* w, unsigned shift) {
  const unsigned lo = __ldg(reinterpret_cast<const unsigned*>(w));
  const unsigned hi = shift ? __ldg(reinterpret_cast<const unsigned*>(w + 4)) : 0u;
  return __funnelshift_r(lo, hi, shift);
}

// One 4x4 block of an MB of `size` pixels: its source rows (4 pixels a
// word), the MB's top row at its columns, the MB's left column at its
// rows, the MB's corner.
struct Block {
  unsigned row[4], top;
  int left[4], tl;
  bool ht, hl;
};

// Block (by, bx) of MB (my, mx) of the image plane at `img` (W pixels a
// row, W a multiple of 4).  kHalo: `halo` holds the image's column left of
// the plane (one byte a row), which MB column 0 reads as its left.
template <bool kHalo>
__device__ __forceinline__ void load_block(const uint8_t* img, int W, int my, int mx,
                                           int size, int by, int bx, const uint8_t* halo,
                                           Block& k) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(img) & 3u);
  const uint8_t* base = img - a;  // 4-byte aligned, as every row's words
  const unsigned shift = 8u * a;
  const int r0 = my * size + by * 4, c0 = mx * size + bx * 4;
  const bool from_halo = kHalo && mx == 0;
  k.ht = my > 0;
  k.hl = mx > 0 || kHalo;
  const uint8_t* w = base + (size_t)r0 * W + c0;
#pragma unroll
  for (int r = 0; r < 4; r++) k.row[r] = load4(w + (size_t)r * W, shift);
  const size_t above = (size_t)(my * size - 1) * W;  // only read when ht
  const int c_left = mx * size - 1;                  // only read when hl
  k.top = k.ht ? load4(base + above + c0, shift) : 0x7F7F7F7Fu;
#pragma unroll
  for (int i = 0; i < 4; i++)
    k.left[i] = from_halo ? halo[r0 + i] : (k.hl ? img[(size_t)(r0 + i) * W + c_left] : 129);
  k.tl = !k.ht ? 127 : from_halo ? halo[my * size - 1] : (!k.hl ? 129 : img[above + c_left]);
}

// The MB's DC prediction; lane-index bits top_lo..top_hi hold the MB's
// block columns, left_lo..left_hi its block rows.
__device__ __forceinline__ int dc_value(const Block& k, int size, int top_lo, int top_hi,
                                        int left_lo, int left_hi) {
  const int sum_top = xor_sum(dot4(k.top, kOnes, 0), top_lo, top_hi);
  const int sum_left = xor_sum(k.left[0] + k.left[1] + k.left[2] + k.left[3], left_lo, left_hi);
  return vp8::dc_whole(sum_top, sum_left, k.ht, k.hl, size);
}

// This lane's part of the four mode SSEs (DC, TM, VE, HE) for DC value
// dc, each as sum(s^2) - 2 sum(s p) + sum(p^2); tm gets the TM
// prediction rows.
__device__ __forceinline__ void block_sse(const Block& k, int dc, unsigned* tm, int* sse) {
  int ss = 0, rs[4], sp_tm = 0, pp_tm = 0, sp_ve = 0, sp_he = 0, pp_he = 0;
  // TM: (top[c] - tl + 256) in 16-bit pairs, plus left[r], clamped to
  // [256, 511]: the low bytes are clip8(left[r] + top[c] - tl)
  const unsigned off = (unsigned)(256 - k.tl) * 0x10001u;
  const unsigned d_lo = __byte_perm(k.top, 0u, 0x4140u) + off;
  const unsigned d_hi = __byte_perm(k.top, 0u, 0x4342u) + off;
#pragma unroll
  for (int r = 0; r < 4; r++) {
    const unsigned s = k.row[r];
    const unsigned l2 = (unsigned)k.left[r] * 0x10001u;
    tm[r] = __byte_perm(clamp_u16x2(d_lo + l2, 0x01000100u, 0x01FF01FFu),
                        clamp_u16x2(d_hi + l2, 0x01000100u, 0x01FF01FFu), 0x6420u);
    ss = dot4(s, s, ss);
    rs[r] = dot4(s, kOnes, 0);
    sp_tm = dot4(s, tm[r], sp_tm);
    pp_tm = dot4(tm[r], tm[r], pp_tm);
    sp_ve = dot4(s, k.top, sp_ve);
    sp_he += k.left[r] * rs[r];
    pp_he += k.left[r] * k.left[r];
  }
  const int sum = rs[0] + rs[1] + rs[2] + rs[3];
  sse[0] = ss + dc * (16 * dc - 2 * sum);
  sse[1] = ss - 2 * sp_tm + pp_tm;
  sse[2] = ss - 2 * sp_ve + 4 * dot4(k.top, k.top, 0);
  sse[3] = ss - 2 * sp_he + 4 * pp_he;
}

// Index of the first minimum of four SSEs (DC, TM, VE, HE).
__device__ __forceinline__ int first_min4(const int* sse) {
  int mode = 0, best = sse[0];
#pragma unroll
  for (int m = 1; m < 4; m++)
    if (sse[m] < best) {
      best = sse[m];
      mode = m;
    }
  return mode;
}

// Raster residual of the block under `mode` (tm: the TM rows).
__device__ __forceinline__ void residual(const Block& k, int mode, int dc, const unsigned* tm,
                                         int* res) {
  const unsigned p_dc = (unsigned)dc * kOnes;
#pragma unroll
  for (int r = 0; r < 4; r++) {
    const unsigned p = mode == 0   ? p_dc
                       : mode == 1 ? tm[r]
                       : mode == 2 ? k.top
                                   : (unsigned)k.left[r] * kOnes;
#pragma unroll
    for (int c = 0; c < 4; c++) res[4 * r + c] = byte_of(k.row[r], c) - byte_of(p, c);
  }
}

// 16 zigzag levels → 32 contiguous bytes (two 16-byte stores).
__device__ __forceinline__ void store_levels(int16_t* out, const int* lv) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = __byte_perm((unsigned)lv[2 * i], (unsigned)lv[2 * i + 1], 0x5410u);
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(w[0], w[1], w[2], w[3]);
  o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

struct Quants {
  int iq_dc, bias_dc, iq_ac, bias_ac;
};

constexpr int kLumaMbs = kThreads / 16, kChromaMbs = kThreads / 8;

template <bool kCode, bool kHalo = false>
__global__ void __launch_bounds__(kThreads)
encode_luma_kernel(const uint8_t* __restrict__ y, long long stride_b, int mh, int mw, Quants q1,
                   Quants q2, int16_t* __restrict__ levels, int16_t* __restrict__ y2_levels,
                   uint8_t* __restrict__ modes, const uint8_t* __restrict__ halo) {
  // A lane past the last MB of the row computes on the last MB, so that
  // every shuffle has its full warp, and stores nothing.
  const int mx_raw = blockIdx.x * kLumaMbs + (threadIdx.x >> 4);
  const bool valid = mx_raw < mw;
  const int mx = valid ? mx_raw : mw - 1, my = blockIdx.y, b = blockIdx.z;
  const int blk = threadIdx.x & 15, by = blk >> 2, bx = blk & 3;
  Block k;
  load_block<kHalo>(y + (size_t)b * stride_b, mw * 16, my, mx, 16, by, bx,
                    kHalo ? halo + (size_t)b * mh * 16 : nullptr, k);
  const int dc = dc_value(k, 16, 1, 2, 4, 8);
  unsigned tm[4];
  int sse[4];
  block_sse(k, dc, tm, sse);
#pragma unroll
  for (int m = 0; m < 4; m++) sse[m] = xor_sum(sse[m], 1, 8);
  const int mode = first_min4(sse);
  const size_t mb = ((size_t)b * mh + my) * mw + mx;
  if (!kCode) {
    if (valid && blk == 0) modes[mb] = (uint8_t)mode;
    return;
  }
  int res[16], cf[16], lv[16];
  residual(k, mode, dc, tm, res);
  vp8::fdct4x4(res, cf);
  vp8::quantize(cf, q1.iq_dc, q1.iq_ac, q1.bias_dc, q1.bias_ac, true, lv);
  // Y2: coefficient blk of the WHT of the MB's 16 block DCs, quantized
  const int y2 = vp8::fwht_lane(cf[0], blk);
  const int y2_level = vp8::quant_lane(y2, blk, q2.iq_dc, q2.iq_ac, q2.bias_dc, q2.bias_ac, false);
  if (!valid) return;
  store_levels(levels + (mb * 16 + blk) * 16, lv);
  y2_levels[mb * 16 + vp8::inv_zigzag(blk)] = (int16_t)y2_level;
  if (blk == 0) modes[mb] = (uint8_t)mode;
}

template <bool kCode, bool kHalo = false>
__global__ void __launch_bounds__(kThreads)
encode_chroma_kernel(const uint8_t* __restrict__ u, long long stride_u,
                     const uint8_t* __restrict__ v, long long stride_v, int mh, int mw, Quants q,
                     int16_t* __restrict__ levels, uint8_t* __restrict__ modes,
                     const uint8_t* __restrict__ hu, const uint8_t* __restrict__ hv) {
  const int mx_raw = blockIdx.x * kChromaMbs + (threadIdx.x >> 3);
  const bool valid = mx_raw < mw;
  const int mx = valid ? mx_raw : mw - 1, my = blockIdx.y, b = blockIdx.z;
  // lanes of one MB: bx in bit 0, by in bit 1, the plane (U, V) in bit 2
  const int blk = threadIdx.x & 7, pl = blk >> 2, by = (blk >> 1) & 1, bx = blk & 1;
  Block k;
  load_block<kHalo>(pl ? v + (size_t)b * stride_v : u + (size_t)b * stride_u, mw * 8, my, mx, 8,
                    by, bx, kHalo ? (pl ? hv : hu) + (size_t)b * mh * 8 : nullptr, k);
  const int dc = dc_value(k, 8, 1, 1, 2, 2);
  unsigned tm[4];
  int sse[4];
  block_sse(k, dc, tm, sse);
#pragma unroll
  for (int m = 0; m < 4; m++) sse[m] = xor_sum(sse[m], 1, 4);  // joint U+V
  const int mode = first_min4(sse);
  const size_t mb = ((size_t)b * mh + my) * mw + mx;
  if (!kCode) {
    if (valid && blk == 0) modes[mb] = (uint8_t)mode;
    return;
  }
  int res[16], cf[16], lv[16];
  residual(k, mode, dc, tm, res);
  vp8::fdct4x4(res, cf);
  vp8::quantize(cf, q.iq_dc, q.iq_ac, q.bias_dc, q.bias_ac, false, lv);
  if (!valid) return;
  store_levels(levels + (mb * 8 + blk) * 16, lv);
  if (blk == 0) modes[mb] = (uint8_t)mode;
}

int strips(int mw, int per_block) { return (mw + per_block - 1) / per_block; }

}  // namespace

// levels / y2_levels null: the modes-only form.  halo non-null (with the
// levels): the halo form, halo (B, 16 mh) contiguous, the column left of
// each image's plane.
extern "C" int encode_luma_launch(const uint8_t* y, long long stride_b, int B, int mh, int mw,
                                  int iq_dc, int bias_dc, int iq_ac, int bias_ac, int iq2_dc,
                                  int bias2_dc, int iq2_ac, int bias2_ac, int16_t* levels,
                                  int16_t* y2_levels, uint8_t* modes, const uint8_t* halo,
                                  void* stream) {
  if (B <= 0 || mh <= 0 || mw <= 0) return 0;
  const dim3 grid(strips(mw, kLumaMbs), mh, B);
  const Quants q1{iq_dc, bias_dc, iq_ac, bias_ac}, q2{iq2_dc, bias2_dc, iq2_ac, bias2_ac};
  if (halo)
    encode_luma_kernel<true, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, stride_b, mh, mw, q1, q2, levels, y2_levels, modes, halo);
  else if (levels)
    encode_luma_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, stride_b, mh, mw, q1, q2, levels, y2_levels, modes, nullptr);
  else
    encode_luma_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        y, stride_b, mh, mw, q1, q2, levels, y2_levels, modes, nullptr);
  return (int)cudaGetLastError();
}

// levels null: the modes-only form.  hu, hv non-null (with the levels):
// the halo form, each (B, 8 mh) contiguous, the columns left of each
// image's planes.
extern "C" int encode_chroma_launch(const uint8_t* u, long long stride_u, const uint8_t* v,
                                    long long stride_v, int B, int mh, int mw, int iq_dc,
                                    int bias_dc, int iq_ac, int bias_ac, int16_t* levels,
                                    uint8_t* modes, const uint8_t* hu, const uint8_t* hv,
                                    void* stream) {
  if (B <= 0 || mh <= 0 || mw <= 0) return 0;
  const dim3 grid(strips(mw, kChromaMbs), mh, B);
  const Quants q{iq_dc, bias_dc, iq_ac, bias_ac};
  if (hu)
    encode_chroma_kernel<true, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        u, stride_u, v, stride_v, mh, mw, q, levels, modes, hu, hv);
  else if (levels)
    encode_chroma_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        u, stride_u, v, stride_v, mh, mw, q, levels, modes, nullptr, nullptr);
  else
    encode_chroma_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        u, stride_u, v, stride_v, mh, mw, q, levels, modes, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// Blocks of 128 threads one SM holds at once of kernel `which` (0 luma,
// 1 chroma, 2 luma modes-only, 3 chroma modes-only), and the card's SMs.
extern "C" int encode_plane_occupancy(int which, int* sms, int* per_sm) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = which == 0   ? (const void*)encode_luma_kernel<true>
                   : which == 1 ? (const void*)encode_chroma_kernel<true>
                   : which == 2 ? (const void*)encode_luma_kernel<false>
                                : (const void*)encode_chroma_kernel<false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, 0);
}
