// The batch decode's sparse coefficient unpack: packed levels back to the
// dense (B, N, 24, 16) int16 raster coefficients that recon_filter_mb
// reads.
//
// Replaces gowebp_tpu/ops/coeff_pack.py:260 unpack_coeffs, an XLA
// function (no pallas_call) that ran fused at the head of the TPU's recon
// program.  The layout (ops/coeff_pack.py): lv8 holds the first K int8
// zigzag levels of every block; a tail row (block index, the levels
// K..15) for each block whose non-zeros reach past K; dc16 the i16 MBs'
// luma DC lanes; an exception row (block index, the raw int16 zigzag
// row) for each block that does not fit the level form; seg, is_i4 and
// qmat the quantizers.  The order that makes the result right: the tail
// levels join the block before the multiply by the quantizer, the i16 DC
// lanes replace position 0 after it, and the exception rows replace
// whole blocks last.
//
// Three launches on the caller's stream, in that order:
//   unpack_dense: one thread a 4x4 block.  It loads the block's K levels
//     (one 4, 8 or 16-byte load where the buffer allows it), multiplies
//     them by the segment's DC or AC quantizer, puts the i16 DC lane in,
//     permutes zigzag to raster in registers and writes the 32-byte row
//     as two 16-byte stores (positions K..15 zero);
//   unpack_tails: one thread a tail row, its levels times the AC
//     quantizer into positions K..15 (raster) of its block; never
//     position 0, so the dense pass's DC stands;
//   unpack_exceptions: one thread an exception row, the raw row into the
//     whole block.
// Row kernels read a table index as the reference's scatter does (a
// negative one counts from the end; one outside the blocks is dropped,
// mode="drop"), and run only when their table has rows.  A segment id
// above 3 takes segment 0's quantizers, as the reference's select does.
// Products are cut to int16 as the dense int16 layout holds them (the
// pack's levels times their quantizer always fit).
//
// Bound on the card: bytes.  Per MB it writes 768 bytes and reads 24 K
// level bytes, 32 of dc16, 2 of seg and is_i4, plus the table rows; a
// block takes ~60 integer operations.  The dense pass is the whole of
// it; neighbouring threads read neighbouring level rows and write
// neighbouring 32-byte rows, so both streams coalesce.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Raster index of zigzag position n: nibble n (RFC 6386's zigzag order
// 0 1 4 8 5 2 3 6 9 12 13 10 7 11 14 15).
constexpr unsigned long long kZigzag = 0xfeb7adc963258410ull;

__host__ __device__ constexpr int raster_of(int n) {
  return (int)((kZigzag >> (4 * n)) & 15);
}

__device__ __forceinline__ const int32_t* quants(const uint8_t* seg,
                                                 const int32_t* qmat,
                                                 uint32_t mb, uint32_t n_mb) {
  const uint32_t b = mb / n_mb;
  const int s = seg[mb];
  return qmat + b * 24 + (s < 4 ? s : 0) * 6;
}

// A table index as the reference's scatter reads it: a negative one
// counts from the end, and one outside the blocks then is dropped (-1).
__device__ __forceinline__ int64_t wrap(int32_t idx, uint32_t nblocks) {
  const int64_t g = idx < 0 ? (int64_t)idx + nblocks : (int64_t)idx;
  return g < (int64_t)nblocks ? g : -1;
}

// The block's K levels into lv[0..K), zeros after: one K-byte load
// where the row is K-aligned (every row is when the buffer is), else K
// byte loads.
template <int K>
__device__ __forceinline__ void load_levels(const int8_t* row, bool aligned,
                                            int (&lv)[16]) {
  if (aligned) {
    uint32_t w[K / 4];
    if constexpr (K == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (K == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(row);
    }
#pragma unroll
    for (int n = 0; n < K; n++)
      lv[n] = (int)(int8_t)(w[n >> 2] >> (8 * (n & 3)));
  } else {
#pragma unroll
    for (int n = 0; n < K; n++) lv[n] = row[n];
  }
#pragma unroll
  for (int n = K; n < 16; n++) lv[n] = 0;
}

template <int K>
__global__ void __launch_bounds__(kThreads) unpack_dense(
    const int8_t* __restrict__ lv8, const int16_t* __restrict__ dc16,
    const uint8_t* __restrict__ seg, const uint8_t* __restrict__ is_i4,
    const int32_t* __restrict__ qmat, uint32_t nblocks, uint32_t n_mb,
    bool aligned, int16_t* __restrict__ out) {
  const uint32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= nblocks) return;
  const uint32_t mb = g / 24;
  const uint32_t blk = g - mb * 24;
  const int32_t* q = quants(seg, qmat, mb, n_mb);
  const bool luma = blk < 16;
  const int q_dc = luma ? q[0] : q[4];
  const int q_ac = luma ? q[1] : q[5];
  int lv[16];
  load_levels<K>(lv8 + (size_t)g * K, aligned, lv);
  int r[16];
#pragma unroll
  for (int n = 0; n < 16; n++) r[raster_of(n)] = lv[n] * (n ? q_ac : q_dc);
  if (luma && is_i4[mb] == 0) r[0] = dc16[(size_t)mb * 16 + blk];
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; i++)
    w[i] = (uint32_t)(uint16_t)r[2 * i] | ((uint32_t)(uint16_t)r[2 * i + 1]
                                           << 16);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)g * 16);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kThreads) unpack_tails(
    const int32_t* __restrict__ tail_idx, const int8_t* __restrict__ tail_val,
    uint32_t ntail, int K, const uint8_t* __restrict__ seg,
    const int32_t* __restrict__ qmat, uint32_t nblocks, uint32_t n_mb,
    int16_t* __restrict__ out) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= ntail) return;
  const int64_t g = wrap(tail_idx[t], nblocks);
  if (g < 0) return;
  const uint32_t mb = (uint32_t)g / 24;
  const int32_t* q = quants(seg, qmat, mb, n_mb);
  const int q_ac = ((uint32_t)g - mb * 24) < 16 ? q[1] : q[5];
  const int8_t* v = tail_val + (size_t)t * (16 - K);
  int16_t* o = out + (size_t)g * 16;
  for (int n = K; n < 16; n++) o[raster_of(n)] = (int16_t)(v[n - K] * q_ac);
}

__global__ void __launch_bounds__(kThreads) unpack_exceptions(
    const int32_t* __restrict__ exc_idx, const int16_t* __restrict__ exc_val,
    uint32_t nexc, uint32_t nblocks, int16_t* __restrict__ out) {
  const uint32_t e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nexc) return;
  const int64_t g = wrap(exc_idx[e], nblocks);
  if (g < 0) return;
  const int16_t* v = exc_val + (size_t)e * 16;
  int16_t* o = out + (size_t)g * 16;
#pragma unroll
  for (int n = 0; n < 16; n++) o[raster_of(n)] = v[n];
}

unsigned blocks_for(uint32_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// nblocks = B * n_mb * 24 and the table lengths must stay under 2^31 (the
// wrapper checks); K is 4, 8 or 16.
extern "C" int unpack_coeffs_launch(
    const int8_t* lv8, const int16_t* dc16, const int32_t* tail_idx,
    const int8_t* tail_val, int ntail, const int32_t* exc_idx,
    const int16_t* exc_val, int nexc, const uint8_t* seg,
    const uint8_t* is_i4, const int32_t* qmat, int B, int n_mb, int K,
    int16_t* out, cudaStream_t stream) {
  const uint32_t nblocks = (uint32_t)B * (uint32_t)n_mb * 24u;
  if (K != 4 && K != 8 && K != 16) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(lv8) % K) == 0;
  cudaError_t err;
  if (nblocks > 0) {
    const unsigned grid = blocks_for(nblocks);
    if (K == 16)
      unpack_dense<16><<<grid, kThreads, 0, stream>>>(
          lv8, dc16, seg, is_i4, qmat, nblocks, n_mb, aligned, out);
    else if (K == 8)
      unpack_dense<8><<<grid, kThreads, 0, stream>>>(
          lv8, dc16, seg, is_i4, qmat, nblocks, n_mb, aligned, out);
    else
      unpack_dense<4><<<grid, kThreads, 0, stream>>>(
          lv8, dc16, seg, is_i4, qmat, nblocks, n_mb, aligned, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (K < 16 && ntail > 0) {
    unpack_tails<<<blocks_for(ntail), kThreads, 0, stream>>>(
        tail_idx, tail_val, ntail, K, seg, qmat, nblocks, n_mb, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (nexc > 0) {
    unpack_exceptions<<<blocks_for(nexc), kThreads, 0, stream>>>(
        exc_idx, exc_val, nexc, nblocks, out);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
