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
// Bound on the card: bytes.  Per MB it writes 768 bytes and reads 24 K
// level bytes, 32 of dc16, 2 of seg and is_i4, plus the table rows; a
// block takes ~60 integer operations.
//
// One launch.  A CTA of kThreads threads owns kRange consecutive blocks
// (32 MBs) and writes each of them once, from registers:
//   1. every thread loads the K levels (one 4, 8 or 16-byte load where
//      the buffer allows it) and the DC lane of its kPer blocks, one warp
//      its MBs' segment, i4 flag and quantizer row; meanwhile six warps
//      find the CTA's rows in the two tables by 33-ary searches (32 lanes
//      probe 32 keys a step: 4 dependent steps for 1M rows);
//   2. the CTA maps each row of its spans to its block's slot and copies
//      the span's tail levels, which are contiguous in tail_val, into
//      shared memory with coalesced 16-byte loads;
//   3. each thread builds its blocks: levels, tail levels, the multiply
//      by the DC or AC quantizer, the i16 DC lane, the exception row over
//      the whole block, zigzag to raster; a warp passes its 32 blocks
//      through shared memory and stores them as two 512-byte runs, one
//      16-byte store a lane (on an H100 faster than two 16-byte stores a
//      lane that each fill half of 32 sectors).
// So a warp's loads and stores are contiguous, and no block is written
// twice (a second pass over the tail rows, one thread a row, re-reading
// the quantizers and storing 2-byte levels into blocks already written,
// took three quarters of a dense-then-rows design's time at K=4).
//
// The contract that lets a CTA find its rows: each table is in block
// order.  A row's key is its index as the reference's scatter reads it (a
// negative one counts from the end; one outside the blocks then is
// dropped and keys as nblocks); keys must increase strictly, dropped rows
// coming after every valid one.  The port's packs and the reference's
// padded tables are so.  The kernel checks the contract as it goes, with
// no extra pass: the searches' invariant (key[t-1] < x <= key[t]) bounds
// each span, every row of a span must key inside the CTA's range above
// its predecessor, and the rows after the last valid one must be dropped
// (spread over the grid).  A table out of order stops the kernel with a
// trap; the error (cudaErrorLaunchFailure) shows at the caller's next
// synchronizing call.  At K=16 the tail table is not read, as the
// reference ignores it.  A segment id above 3 takes segment 0's
// quantizers, as the reference's select does.  Products are cut to int16
// as the dense int16 layout holds them (the pack's levels times their
// quantizer always fit).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 3;                      // blocks a thread
constexpr int kRange = kThreads * kPer;      // blocks a CTA
constexpr int kMBs = kRange / 24;
static_assert(kRange % 24 == 0 && kMBs <= 32, "one warp loads the MBs");
// Raster index of zigzag position n: nibble n (RFC 6386's zigzag order
// 0 1 4 8 5 2 3 6 9 12 13 10 7 11 14 15).
constexpr unsigned long long kZigzag = 0xfeb7adc963258410ull;

std::atomic<unsigned long long> g_launches{0};

__host__ __device__ constexpr int raster_of(int n) {
  return (int)((kZigzag >> (4 * n)) & 15);
}

// A row's key: its block, or nblocks where the reference drops it.
__device__ __forceinline__ uint32_t key_of(int32_t idx, uint32_t nblocks) {
  const int64_t g = idx < 0 ? (int64_t)idx + nblocks : (int64_t)idx;
  return (g >= 0 && g < (int64_t)nblocks) ? (uint32_t)g : nblocks;
}

// The first row t of idx[0, n) with key >= x, by one warp: each step the
// 32 lanes probe 32 rows that cut [lo, hi) into 33 parts.  Whatever the
// order, the result keeps key[t - 1] < x (t > 0) and key[t] >= x (t < n).
__device__ uint32_t lower_bound(const int32_t* __restrict__ idx, uint32_t n,
                                uint32_t nblocks, uint32_t x, int lane) {
  uint32_t lo = 0, hi = n;
  while (lo < hi) {
    const uint64_t len = hi - lo;
    const uint32_t q = lo + (uint32_t)(len * (lane + 1) / 33);
    const unsigned ge =
        __ballot_sync(0xffffffffu, key_of(idx[q], nblocks) >= x);
    const int f = ge ? __ffs(ge) - 1 : 32;
    if (f < 32) hi = lo + (uint32_t)(len * (f + 1) / 33);
    if (f > 0) lo += (uint32_t)(len * f / 33) + 1;
  }
  return lo;
}

// The block's K levels as K/4 words: one K-byte load where the row is
// K-aligned (every row is when the buffer is), else K byte loads.
template <int K>
__device__ __forceinline__ void load_levels(const int8_t* row, bool aligned,
                                            uint32_t (&w)[K / 4]) {
  if (aligned) {
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
  } else {
#pragma unroll
    for (int i = 0; i < K / 4; i++) {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(row) + 4 * i;
      w[i] = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    }
  }
}

__device__ __forceinline__ int byte_of(uint32_t w, int i) {
  return (int)(int8_t)(w >> (8 * i));
}

// Eight CTAs an SM at K=4 (32 registers); K=8 and 16 need 40 without a
// stack frame, so six.
template <int K>
__global__ void __launch_bounds__(kThreads, K == 4 ? 8 : 6)
unpack_coeffs_kernel(
    const int8_t* __restrict__ lv8, const int16_t* __restrict__ dc16,
    const int32_t* __restrict__ tail_idx, const int8_t* __restrict__ tail_val,
    uint32_t ntail, const int32_t* __restrict__ exc_idx,
    const int16_t* __restrict__ exc_val, uint32_t nexc,
    const uint8_t* __restrict__ seg, const uint8_t* __restrict__ is_i4,
    const int32_t* __restrict__ qmat, uint32_t nblocks, uint32_t n_mb,
    bool lv_aligned, int16_t* __restrict__ out) {
  constexpr int TW = 16 - K;                 // tail levels a row
  __shared__ __align__(16) uint8_t s_tv[K < 16 ? kRange * TW + 16 : 16];
  __shared__ uint16_t s_tail[kRange];        // span row + 1, 0 for none
  __shared__ uint16_t s_exc[kRange];
  __shared__ int4 s_q[kMBs];                 // dc, ac luma; dc, ac chroma
  __shared__ uint8_t s_i16[kMBs];
  __shared__ uint32_t s_span[6];
  __shared__ __align__(16) uint4 s_out[kThreads / 32][64];  // 32 blocks a warp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t g0 = blockIdx.x * kRange;
  const uint32_t g1 = min(g0 + kRange, nblocks);
  const uint32_t ntail_k = K < 16 ? ntail : 0;

  // 1. levels and DC lanes in flight while the searches run
  uint32_t w[kPer][K / 4];
  int dc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; i++) {
    const uint32_t g = g0 + tid + i * kThreads;
    dc[i] = 0;
    if (g < g1) {
      load_levels<K>(lv8 + (size_t)g * K, lv_aligned, w[i]);
      const uint32_t mb = g / 24, blk = g - mb * 24;
      if (blk < 16) dc[i] = dc16[(size_t)mb * 16 + blk];
    }
  }
  for (int j = tid; j < kRange; j += kThreads) s_tail[j] = s_exc[j] = 0;
  if (warp < 6) {
    // warps 0-2: the tail table at g0, g1, nblocks; 3-5 the exceptions'
    const bool tails = warp < 3;
    const int which = warp % 3;
    const uint32_t x = which == 0 ? g0 : which == 1 ? g1 : nblocks;
    const uint32_t t = lower_bound(tails ? tail_idx : exc_idx,
                                   tails ? ntail_k : nexc, nblocks, x, lane);
    if (lane == 0) s_span[warp] = t;
  } else if (warp == 7 && lane < kMBs) {
    const uint32_t mb = g0 / 24 + lane;
    if (mb < nblocks / 24) {
      const int s = seg[mb];
      const int32_t* q = qmat + (size_t)(mb / n_mb) * 24 + (s < 4 ? s : 0) * 6;
      s_q[lane] = make_int4(q[0], q[1], q[4], q[5]);
      s_i16[lane] = is_i4[mb] == 0;
    }
  }
  __syncthreads();
  const uint32_t t0 = s_span[0], t1 = s_span[1], t_end = s_span[2];
  const uint32_t e0 = s_span[3], e1 = s_span[4], e_end = s_span[5];
  // (uniform over the CTA, so no thread stages an oversized span)
  if (t1 < t0 || t1 - t0 > g1 - g0 || e1 < e0 || e1 - e0 > g1 - g0)
    __trap();

  // 2. the spans' rows to their blocks' slots; the tail levels staged
  for (uint32_t r = t0 + tid; r < t1; r += kThreads) {
    const uint32_t k = key_of(tail_idx[r], nblocks);
    if (k < g0 || k >= g1 || (r > t0 && key_of(tail_idx[r - 1], nblocks) >= k))
      __trap();
    s_tail[k - g0] = (uint16_t)(r - t0 + 1);
  }
  for (uint32_t r = e0 + tid; r < e1; r += kThreads) {
    const uint32_t k = key_of(exc_idx[r], nblocks);
    if (k < g0 || k >= g1 || (r > e0 && key_of(exc_idx[r - 1], nblocks) >= k))
      __trap();
    s_exc[k - g0] = (uint16_t)(r - e0 + 1);
  }
  // The span's bytes from the 16-byte boundary at or below its start:
  // the edge chunks lie in the same 16 bytes as a byte of the table, so
  // inside its allocation's mapped pages.
  uint32_t t_off = 0;
  if (K < 16 && t1 > t0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(tail_val) + (size_t)t0 * TW;
    const uintptr_t a16 = a & ~(uintptr_t)15;
    t_off = (uint32_t)(a - a16);
    const uint32_t n16 = (t_off + (t1 - t0) * TW + 15) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(a16);
    for (uint32_t c = tid; c < n16; c += kThreads)
      reinterpret_cast<uint4*>(s_tv)[c] = src[c];
  }
  __syncthreads();

  // 3. each block from registers, written once: a warp's 32 blocks go
  // through s_out so that each store covers 512 contiguous bytes
  const bool t_words = reinterpret_cast<uintptr_t>(tail_val) % 4 == 0;
#pragma unroll
  for (int i = 0; i < kPer; i++) {
    const uint32_t j = tid + i * kThreads;
    // (the warp's lanes past g1 build from unset levels and store nothing)
    if (g0 + (j & ~31u) >= g1) break;
    const uint32_t m = j / 24, blk = j - m * 24;
    const int4 q = s_q[m];
    const bool luma = blk < 16;
    const int q_dc = luma ? q.x : q.z, q_ac = luma ? q.y : q.w;
    int lv[16];
#pragma unroll
    for (int n = 0; n < K; n++) lv[n] = byte_of(w[i][n >> 2], n & 3);
#pragma unroll
    for (int n = K; n < 16; n++) lv[n] = 0;
    if constexpr (K < 16) {
      const uint32_t ts = s_tail[j];
      if (ts) {
        const uint8_t* v = s_tv + t_off + (ts - 1) * TW;
        if (t_words) {
#pragma unroll
          for (int c = 0; c < TW / 4; c++) {
            const uint32_t x = *reinterpret_cast<const uint32_t*>(v + 4 * c);
#pragma unroll
            for (int b = 0; b < 4; b++) lv[K + 4 * c + b] = byte_of(x, b);
          }
        } else {
#pragma unroll
          for (int n = 0; n < TW; n++) lv[K + n] = (int8_t)v[n];
        }
      }
    }
    int r[16];
#pragma unroll
    for (int n = 0; n < 16; n++) r[raster_of(n)] = lv[n] * (n ? q_ac : q_dc);
    if (luma && s_i16[m]) r[0] = dc[i];
    const uint32_t es = s_exc[j];
    if (es) {
      const int16_t* v = exc_val + (size_t)(e0 + es - 1) * 16;
#pragma unroll
      for (int n = 0; n < 16; n++) r[raster_of(n)] = v[n];
    }
    uint32_t o[8];
#pragma unroll
    for (int c = 0; c < 8; c++)
      o[c] = (uint32_t)(uint16_t)r[2 * c] |
             ((uint32_t)(uint16_t)r[2 * c + 1] << 16);
    uint4* so = s_out[warp];
    so[2 * lane] = make_uint4(o[0], o[1], o[2], o[3]);
    so[2 * lane + 1] = make_uint4(o[4], o[5], o[6], o[7]);
    __syncwarp();
    const uint32_t wb = g0 + (j & ~31u);     // the warp's first block
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)wb * 16);
    if (wb + (lane >> 1) < g1) dst[lane] = so[lane];
    if (wb + 16 + (lane >> 1) < g1) dst[32 + lane] = so[32 + lane];
    __syncwarp();
  }

  // Rows after the last valid one must be dropped ones.
  const uint32_t stride = gridDim.x * kThreads;
  if constexpr (K < 16) {
    for (uint32_t r = t_end + blockIdx.x * kThreads + tid; r < ntail;
         r += stride)
      if (key_of(tail_idx[r], nblocks) != nblocks) __trap();
  }
  for (uint32_t r = e_end + blockIdx.x * kThreads + tid; r < nexc; r += stride)
    if (key_of(exc_idx[r], nblocks) != nblocks) __trap();
}

}  // namespace

// nblocks = B * n_mb * 24 and the table lengths must stay under 2^31 (the
// wrapper checks); K is 4, 8 or 16.  One launch, none for no blocks.
extern "C" int unpack_coeffs_launch(
    const int8_t* lv8, const int16_t* dc16, const int32_t* tail_idx,
    const int8_t* tail_val, int ntail, const int32_t* exc_idx,
    const int16_t* exc_val, int nexc, const uint8_t* seg,
    const uint8_t* is_i4, const int32_t* qmat, int B, int n_mb, int K,
    int16_t* out, cudaStream_t stream) {
  const uint32_t nblocks = (uint32_t)B * (uint32_t)n_mb * 24u;
  if (K != 4 && K != 8 && K != 16) return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(lv8) % K) == 0;
  const unsigned grid = (nblocks + kRange - 1) / kRange;
  if (K == 16)
    unpack_coeffs_kernel<16><<<grid, kThreads, 0, stream>>>(
        lv8, dc16, tail_idx, tail_val, ntail, exc_idx, exc_val, nexc, seg,
        is_i4, qmat, nblocks, n_mb, aligned, out);
  else if (K == 8)
    unpack_coeffs_kernel<8><<<grid, kThreads, 0, stream>>>(
        lv8, dc16, tail_idx, tail_val, ntail, exc_idx, exc_val, nexc, seg,
        is_i4, qmat, nblocks, n_mb, aligned, out);
  else
    unpack_coeffs_kernel<4><<<grid, kThreads, 0, stream>>>(
        lv8, dc16, tail_idx, tail_val, ntail, exc_idx, exc_val, nexc, seg,
        is_i4, qmat, nblocks, n_mb, aligned, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  g_launches.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// Kernel launches made by this library since it was loaded.
extern "C" unsigned long long unpack_coeffs_kernel_launches() {
  return g_launches.load(std::memory_order_relaxed);
}
