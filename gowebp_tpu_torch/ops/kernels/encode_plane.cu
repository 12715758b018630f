// Open-loop macroblock encode: the luma and chroma plane kernels.
//
// Replace the TPU kernels of gowebp_tpu/ops/pallas/encode_plane.py:
// encode_luma_kernel replaces _run_luma (_luma_kernel), and
// encode_chroma_kernel replaces _run_chroma (_chroma_kernel).  Same
// integer semantics as ops/encode_plane.py's plain versions.
//
// The engine is open-loop: prediction context comes from the source
// plane, so macroblocks do not depend on one another.  One thread owns
// one 4x4 block: 16 lanes make a luma MB, 8 lanes a chroma MB (U blocks
// 0-3, V blocks 4-7).  Each lane reads its 16 source pixels, its share
// of the row above and the column to the left and the corner straight
// from the uint8 plane, with the decoder's edge fills as index tests
// (127 on the top MB row, corner included; 129 on the left MB column).
// The DC sums and the four mode SSEs are reduced across the MB's lanes
// with warp shuffles, so every lane picks the same mode: DC, TM, VE, HE
// in that order, first minimum wins (strict <).  Then each lane takes
// its residual, FDCT and quantization in registers and writes its 16
// zigzag levels as int16 straight into the per-MB layout the emitter
// reads.  The luma kernel also runs the Y2 path, which the TPU version
// left to XLA: each of an MB's 16 lanes gathers the MB's 16 DC
// coefficients by shuffle, computes one coefficient of their
// Walsh-Hadamard transform and quantizes it.
//
// Bound on the card: bytes (about 1 byte read against 2.1 bytes written
// per pixel, and some 38 integer operations per pixel).  No shared
// memory and no block-level synchronisation: the registers hold
// everything, and the outputs of a MB's lanes are contiguous.

#include <cuda_runtime.h>

#include <cstdint>

#include "vp8_dsp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Signs of the 4-point Walsh-Hadamard rows of vp8's FWHT, bit c of row i
// set where the factor is -1: [+ + + +], [+ + - -], [+ - - +], [+ - + -].
__constant__ int kWalshNeg[4] = {0x0, 0xC, 0x6, 0xA};

// Sum of v over the lanes whose index differs in the bits lo..hi.
__device__ __forceinline__ int xor_sum(int v, int lo, int hi) {
  for (int o = lo; o <= hi; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

__device__ __forceinline__ int predict(int mode, int dc, int tm, int ve, int he) {
  return mode == 0 ? dc : (mode == 1 ? tm : (mode == 2 ? ve : he));
}

// One 4x4 block of an MB of `size` pixels at plane row r0, column c0:
// source pixels, the block's top and left context, the MB's corner.
struct Block {
  int src[16], top[4], left[4], tl;
  bool ht, hl;
};

__device__ __forceinline__ void load_block(const uint8_t* plane, int W, int my, int mx,
                                           int size, int by, int bx, Block& k) {
  const int r0 = my * size + by * 4, c0 = mx * size + bx * 4;
  k.ht = my > 0;
  k.hl = mx > 0;
#pragma unroll
  for (int r = 0; r < 4; r++)
#pragma unroll
    for (int c = 0; c < 4; c++) k.src[4 * r + c] = plane[(size_t)(r0 + r) * W + c0 + c];
  const uint8_t* above = plane + (k.ht ? (size_t)(my * size - 1) * W : 0);
  const int c_left = k.hl ? mx * size - 1 : 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    k.top[i] = k.ht ? above[c0 + i] : 127;
    k.left[i] = k.hl ? plane[(size_t)(r0 + i) * W + c_left] : 129;
  }
  k.tl = !k.ht ? 127 : (!k.hl ? 129 : above[c_left]);
}

// This lane's part of the four mode SSEs for DC value `dc`.
__device__ __forceinline__ void block_sse(const Block& k, int dc, int* sse) {
#pragma unroll
  for (int m = 0; m < 4; m++) sse[m] = 0;
#pragma unroll
  for (int r = 0; r < 4; r++)
#pragma unroll
    for (int c = 0; c < 4; c++) {
      const int s = k.src[4 * r + c];
      const int d0 = s - dc;
      const int d1 = s - vp8::clip8(k.left[r] + k.top[c] - k.tl);
      const int d2 = s - k.top[c];
      const int d3 = s - k.left[r];
      sse[0] += d0 * d0;
      sse[1] += d1 * d1;
      sse[2] += d2 * d2;
      sse[3] += d3 * d3;
    }
}

// Residual under `mode`, FDCT and quantization → raster coeffs + levels.
__device__ __forceinline__ void code_block(const Block& k, int mode, int dc, int iq_dc,
                                           int bias_dc, int iq_ac, int bias_ac,
                                           bool zero_dc, int* cf, int* lv) {
  int res[16];
#pragma unroll
  for (int r = 0; r < 4; r++)
#pragma unroll
    for (int c = 0; c < 4; c++) {
      const int tm = vp8::clip8(k.left[r] + k.top[c] - k.tl);
      res[4 * r + c] = k.src[4 * r + c] - predict(mode, dc, tm, k.top[c], k.left[r]);
    }
  vp8::fdct4x4(res, cf);
  vp8::quantize(cf, iq_dc, iq_ac, bias_dc, bias_ac, zero_dc, lv);
}

// QUANTDIV of one coefficient (clamp 2047).
__device__ __forceinline__ int quant1(int v, int iq, int bias) {
  const int av = v < 0 ? -v : v;
  int lvl = (av * iq + bias) >> 17;
  lvl = lvl > 2047 ? 2047 : lvl;
  return v < 0 ? -lvl : lvl;
}

// 16 zigzag levels → 32 contiguous bytes (two 16-byte stores).
__device__ __forceinline__ void store_levels(int16_t* out, const int* lv) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 8; i++)
    w[i] = (unsigned)(uint16_t)lv[2 * i] | ((unsigned)(uint16_t)lv[2 * i + 1] << 16);
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(w[0], w[1], w[2], w[3]);
  o[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kThreads)
encode_luma_kernel(const uint8_t* __restrict__ y, long long stride_b, int n_mb, int mh,
                   int mw, int iq_dc, int bias_dc, int iq_ac, int bias_ac, int iq2_dc,
                   int bias2_dc, int iq2_ac, int bias2_ac, int16_t* __restrict__ levels,
                   int16_t* __restrict__ y2_levels, uint8_t* __restrict__ modes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // A lane past the last MB computes on the last MB, so that every
  // shuffle has its full warp, and stores nothing.
  const bool valid = (t >> 4) < n_mb;
  const int mb = valid ? (int)(t >> 4) : n_mb - 1;
  const int blk = (int)(t & 15), by = blk >> 2, bx = blk & 3;
  const int mx = mb % mw, my = (mb / mw) % mh, b = mb / (mw * mh);
  Block k;
  load_block(y + (size_t)b * stride_b, mw * 16, my, mx, 16, by, bx, k);

  // lanes of one MB: bx in bits 0-1, by in bits 2-3
  const int sum_top = xor_sum(k.top[0] + k.top[1] + k.top[2] + k.top[3], 1, 2);
  const int sum_left = xor_sum(k.left[0] + k.left[1] + k.left[2] + k.left[3], 4, 8);
  const int dc = vp8::dc_whole(sum_top, sum_left, k.ht, k.hl, 16);
  int sse[4];
  block_sse(k, dc, sse);
#pragma unroll
  for (int m = 0; m < 4; m++) sse[m] = xor_sum(sse[m], 1, 8);
  const int mode = first_min4(sse);

  int cf[16], lv[16];
  code_block(k, mode, dc, iq_dc, bias_dc, iq_ac, bias_ac, true, cf, lv);

  // Y2: this lane's coefficient (row by, column bx) of the WHT of the
  // MB's 4x4 grid of block DCs, (sum of +-DC) >> 1, quantized.
  const int lane0 = threadIdx.x & 16;
  int y2 = 0;
#pragma unroll
  for (int s = 0; s < 16; s++) {
    const int d = __shfl_sync(kFull, cf[0], lane0 + s);
    const bool neg = ((kWalshNeg[by] >> (s >> 2)) ^ (kWalshNeg[bx] >> (s & 3))) & 1;
    y2 += neg ? -d : d;
  }
  y2 >>= 1;
  const int y2_level = blk == 0 ? quant1(y2, iq2_dc, bias2_dc) : quant1(y2, iq2_ac, bias2_ac);
  if (!valid) return;
  store_levels(levels + ((size_t)mb * 16 + blk) * 16, lv);
  y2_levels[(size_t)mb * 16 + vp8::inv_zigzag(blk)] = (int16_t)y2_level;
  if (blk == 0) modes[mb] = (uint8_t)mode;
}

__global__ void __launch_bounds__(kThreads)
encode_chroma_kernel(const uint8_t* __restrict__ u, long long stride_u,
                     const uint8_t* __restrict__ v, long long stride_v, int n_mb, int mh,
                     int mw, int iq_dc, int bias_dc, int iq_ac, int bias_ac,
                     int16_t* __restrict__ levels, uint8_t* __restrict__ modes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = (t >> 3) < n_mb;
  const int mb = valid ? (int)(t >> 3) : n_mb - 1;
  // lanes of one MB: bx in bit 0, by in bit 1, the plane (U, V) in bit 2
  const int blk = (int)(t & 7), pl = blk >> 2, by = (blk >> 1) & 1, bx = blk & 1;
  const int mx = mb % mw, my = (mb / mw) % mh, b = mb / (mw * mh);
  Block k;
  load_block(pl ? v + (size_t)b * stride_v : u + (size_t)b * stride_u, mw * 8, my, mx, 8,
             by, bx, k);

  const int sum_top = xor_sum(k.top[0] + k.top[1] + k.top[2] + k.top[3], 1, 1);
  const int sum_left = xor_sum(k.left[0] + k.left[1] + k.left[2] + k.left[3], 2, 2);
  const int dc = vp8::dc_whole(sum_top, sum_left, k.ht, k.hl, 8);
  int sse[4];
  block_sse(k, dc, sse);
#pragma unroll
  for (int m = 0; m < 4; m++) sse[m] = xor_sum(sse[m], 1, 4);  // joint U+V
  const int mode = first_min4(sse);

  int cf[16], lv[16];
  code_block(k, mode, dc, iq_dc, bias_dc, iq_ac, bias_ac, false, cf, lv);
  if (!valid) return;
  store_levels(levels + ((size_t)mb * 8 + blk) * 16, lv);
  if (blk == 0) modes[mb] = (uint8_t)mode;
}

int blocks_for(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int encode_luma_launch(const uint8_t* y, long long stride_b, int B, int mh,
                                  int mw, int iq_dc, int bias_dc, int iq_ac, int bias_ac,
                                  int iq2_dc, int bias2_dc, int iq2_ac, int bias2_ac,
                                  int16_t* levels, int16_t* y2_levels, uint8_t* modes,
                                  void* stream) {
  const int n_mb = B * mh * mw;
  if (n_mb <= 0) return 0;
  encode_luma_kernel<<<blocks_for(16LL * n_mb), kThreads, 0, (cudaStream_t)stream>>>(
      y, stride_b, n_mb, mh, mw, iq_dc, bias_dc, iq_ac, bias_ac, iq2_dc, bias2_dc, iq2_ac,
      bias2_ac, levels, y2_levels, modes);
  return (int)cudaGetLastError();
}

extern "C" int encode_chroma_launch(const uint8_t* u, long long stride_u, const uint8_t* v,
                                    long long stride_v, int B, int mh, int mw, int iq_dc,
                                    int bias_dc, int iq_ac, int bias_ac, int16_t* levels,
                                    uint8_t* modes, void* stream) {
  const int n_mb = B * mh * mw;
  if (n_mb <= 0) return 0;
  encode_chroma_kernel<<<blocks_for(8LL * n_mb), kThreads, 0, (cudaStream_t)stream>>>(
      u, stride_u, v, stride_v, n_mb, mh, mw, iq_dc, bias_dc, iq_ac, bias_ac, levels,
      modes);
  return (int)cudaGetLastError();
}
