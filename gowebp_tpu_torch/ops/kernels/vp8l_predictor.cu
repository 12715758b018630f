// The VP8L encoder's per-tile predictor chooser: for each (1 << bits)-
// square tile of an ARGB image, the one of the 14 VP8L predictors whose
// residuals code cheapest (ops/lossless.py says what it computes).
//
// Replaces gowebp_tpu/ops/lossless_jax.py:269 predictor_search_entropy,
// which the JAX package ran in XLA (no pallas_call): one pass built a
// (14, T, 4, 256) int32 histogram tensor in device memory from int8
// one-hot chunks (235 MB for a 1 MP image at bits 4, 940 MB at bits 3)
// and scored it in float32.  Here nothing of that size exists: one block
// owns one tile, builds the tile's 14 x 4 x 256 histograms in shared
// memory, scores them there and writes only the tile's pick.
//
// One launch a pass: stage 1 (refine = 0) or a refinement round
// (refine = 1).  A block:
// - zeroes 14 x 1024 bins of 16-bit counts, two to a 32-bit word
//   (28 KB; a tile has at most 1024 pixels, so no count carries into its
//   neighbour);
// - takes the tile's pixels, 256 threads a pass: each loads its pixel
//   and L, T, TL, TR once (the decoder's edge rules: row 0 predicts L,
//   column 0 T, the origin black; TR of the last column is the current
//   row's first pixel), forms all 14 residuals (byte-wise x - pred mod
//   256) and adds 56 counts with shared-memory atomics;
// - scores: thread v sums the four channels' bins of byte value v for
//   each mode, as int64 fixed point from `tab` (built on the host in
//   float64, scaled by 2^40 and rounded: ops/lossless.py stage1_table
//   and refine_table), so any order of the sums gives the same integers
//   as the plain version's: stage 1, 4 n log2 n + sum(h * bias(b) -
//   h log2 h); a round, sum(h * -log2 p(bin)) + the mode's cost.  Warp
//   shuffles and a shared row of partials reduce the 14 sums;
// - picks the least score, the lowest mode on a tie (argmin's rule),
//   writes it, counts it, counts a change (a round), and adds the chosen
//   mode's 1024 bins to the global histogram `acc` that the host reads
//   to build the next round's table.
//
// Bound on the card: by operations.  A pixel costs 14 predictions and 56
// shared-memory atomics; a tile's scoring reads 14 x 1024 counts and
// table entries.  The bytes (4 H W a pass, read once) are small beside
// them.  The atomics collide on flat content (every lane of a warp on the
// same bin of a mode), which serializes them: the simple design's cost,
// left as it is.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kModes = 14;
constexpr int kBins = 1024;           // 4 channels x 256 byte values
constexpr int kWords = kBins / 2;     // two 16-bit counts a word
constexpr int kMaxCount = 1024;       // 4^5: the largest tile's pixels
constexpr int kAccWords = kBins + kModes + 1;

__device__ __forceinline__ uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int chan(uint32_t v, int s) {
  return (int)((v >> s) & 0xffu);
}

// L when the T-TL gradient is the smaller (the format's crossed names).
__device__ __forceinline__ uint32_t select_pred(uint32_t l, uint32_t t,
                                                uint32_t tl) {
  int pl = 0, pt = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    pl += abs(chan(t, s) - chan(tl, s));
    pt += abs(chan(l, s) - chan(tl, s));
  }
  return pl < pt ? l : t;
}

__device__ __forceinline__ uint32_t clamped_add_sub_full(uint32_t l,
                                                         uint32_t t,
                                                         uint32_t tl) {
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255(chan(l, s) + chan(t, s) - chan(tl, s)) << s;
  return out;
}

__device__ __forceinline__ uint32_t clamped_add_sub_half(uint32_t l,
                                                         uint32_t t,
                                                         uint32_t tl) {
  const uint32_t ave = avg2(l, t);
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    const int a = chan(ave, s);
    out |= (uint32_t)clip255(a + (a - chan(tl, s)) / 2) << s;  // toward 0
  }
  return out;
}

__device__ __forceinline__ uint32_t predict(int mode, uint32_t l, uint32_t t,
                                            uint32_t tl, uint32_t tr) {
  switch (mode) {
    case 0: return 0xff000000u;
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(l, tr), t);
    case 6: return avg2(l, tl);
    case 7: return avg2(l, t);
    case 8: return avg2(tl, t);
    case 9: return avg2(t, tr);
    case 10: return avg2(avg2(l, tl), avg2(t, tr));
    case 11: return select_pred(l, t, tl);
    case 12: return clamped_add_sub_full(l, t, tl);
    default: return clamped_add_sub_half(l, t, tl);
  }
}

__device__ __forceinline__ uint32_t sub_px(uint32_t x, uint32_t p) {
  const uint32_t lo = ((x | 0x01000100u) - (p & 0x00ff00ffu)) & 0x00ff00ffu;
  const uint32_t hi =
      (((x >> 8) | 0x01000100u) - ((p >> 8) & 0x00ff00ffu)) & 0x00ff00ffu;
  return lo | (hi << 8);
}

// One count for each channel's byte of residual `r` in mode m's bins.
__device__ __forceinline__ void bump(uint32_t* hist, int m, uint32_t r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int bin = (c << 8) | (int)((r >> (24 - 8 * c)) & 0xffu);
    atomicAdd(&hist[m * kWords + (bin >> 1)], 1u << ((bin & 1) << 4));
  }
}

__device__ __forceinline__ int count_of(const uint32_t* hist, int m,
                                        int bin) {
  return (int)((hist[m * kWords + (bin >> 1)] >> ((bin & 1) << 4)) & 0xffffu);
}

__global__ void __launch_bounds__(kThreads)
    vp8l_predictor_kernel(const uint32_t* __restrict__ argb, int h, int w,
                          int bits, const long long* __restrict__ tab,
                          int refine, int* __restrict__ modes,
                          int* __restrict__ acc) {
  __shared__ uint32_t hist[kModes * kWords];
  __shared__ long long part[kWarps][kModes];
  __shared__ int s_best;

  const int tid = threadIdx.x;
  const int ts = 1 << bits;
  const int tw = (w + ts - 1) >> bits;
  const int tile = blockIdx.x;
  const int y0 = (tile / tw) << bits, x0 = (tile % tw) << bits;
  const int th_px = min(ts, h - y0), tw_px = min(ts, w - x0);

  for (int i = tid; i < kModes * kWords; i += kThreads) hist[i] = 0u;
  __syncthreads();

  for (int p = tid; p < ts * ts; p += kThreads) {
    const int dy = p >> bits, dx = p & (ts - 1);
    if (dy >= th_px || dx >= tw_px) continue;
    const int y = y0 + dy, x = x0 + dx;
    const uint32_t* row = argb + (size_t)y * w;
    const uint32_t px = row[x];
    if (y == 0 || x == 0) {           // the same prediction in every mode
      const uint32_t pred = y == 0 ? (x == 0 ? 0xff000000u : row[x - 1])
                                   : row[x - w];
      const uint32_t r = sub_px(px, pred);
#pragma unroll
      for (int m = 0; m < kModes; ++m) bump(hist, m, r);
    } else {
      const uint32_t l = row[x - 1], t = row[x - w], tl = row[x - w - 1];
      const uint32_t tr = x + 1 < w ? row[x - w + 1] : row[0];
#pragma unroll
      for (int m = 0; m < kModes; ++m)
        bump(hist, m, sub_px(px, predict(m, l, t, tl, tr)));
    }
  }
  __syncthreads();

  // thread v: byte value v of each channel
  const int v = tid;
  long long s[kModes];
  if (refine) {
    long long q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = __ldg(&tab[(c << 8) | v]);
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      s[m] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[m] += (long long)count_of(hist, m, (c << 8) | v) * q[c];
    }
  } else {
    const long long bias = __ldg(&tab[kMaxCount + 1 + v]);
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      s[m] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = count_of(hist, m, (c << 8) | v);
        s[m] += (long long)n * bias - __ldg(&tab[n]);
      }
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[m] += __shfl_down_sync(0xffffffffu, s[m], off);
    if (lane == 0) part[warp][m] = s[m];
  }
  __syncthreads();

  if (tid == 0) {
    const long long base = refine ? 0 : 4 * __ldg(&tab[th_px * tw_px]);
    int best = 0;
    long long best_cost = 0;
    for (int m = 0; m < kModes; ++m) {
      long long cost = base + (refine ? __ldg(&tab[kBins + m]) : 0);
      for (int k = 0; k < kWarps; ++k) cost += part[k][m];
      if (m == 0 || cost < best_cost) {
        best_cost = cost;
        best = m;
      }
    }
    if (refine && modes[tile] != best) atomicAdd(&acc[kBins + kModes], 1);
    modes[tile] = best;
    atomicAdd(&acc[kBins + best], 1);
    s_best = best;
  }
  __syncthreads();

  const int best = s_best;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = count_of(hist, best, (c << 8) | v);
    if (n) atomicAdd(&acc[(c << 8) | v], n);
  }
}

}  // namespace

// Zeroes `acc` and launches one pass over the T tiles on `stream`; returns
// the CUDA error code.  tab: stage 1, n log2 n for n in 0..1024 then the
// 256 byte biases; a round, the 1024 bins' -log2 p then the 14 mode costs.
extern "C" int vp8l_predictor_launch(const uint32_t* argb, int h, int w,
                                     int bits, const long long* tab,
                                     int refine, int* modes, int* acc,
                                     void* stream) {
  if (h <= 0 || w <= 0 || bits < 2 || bits > 5) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, kAccWords * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((h + (1 << bits) - 1) >> bits) *
                    ((w + (1 << bits) - 1) >> bits);
  vp8l_predictor_kernel<<<tiles, kThreads, 0, s>>>(argb, h, w, bits, tab,
                                                   refine, modes, acc);
  return (int)cudaGetLastError();
}
