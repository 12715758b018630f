// The VP8L predictor inverse over a batch of residual images sharing one
// mode image, with the add-green inverse as an optional epilogue.
//
// Replaces gowebp_tpu/ops/lossless_jax.py:363 predictor_inverse (a row
// scan with an in-row scan, XLA, no pallas_call), and, with the epilogue,
// :39 add_green_inverse after it, as gowebp_tpu/parallel/shard.py:238
// sharded_lossless_inverse runs them.  Same semantics as the plain
// version, ops/kernels/vp8l_inverse.py predictor_inverse_plain:
//   - row 0: pixel 0 predicts black (0xff000000), every other the pixel to
//     its left;
//   - column 0 of the other rows predicts the pixel above;
//   - elsewhere the tile's mode (bits 8-15 of the mode image's word) picks
//     one of the 14 predictors from L, T, TL and TR; the last column's TR
//     is the current row's pixel 0; a mode past 13 predicts 0;
//   - each pixel is its residual plus the prediction, byte by byte mod 256.
//
// Bound on the card: the bytes (each residual read once, each pixel
// written once) or the few dozen operations a pixel, whichever is larger;
// unreachable, because the recurrence is serial: pixel (y, x) needs its
// left neighbour, so an image is a chain of w + 2 (h - 1) dependent steps.
// The design runs that chain as a skewed wavefront, which is the least
// depth the dependencies allow: one block an image, one thread a row, and
// at step t thread y takes pixel x = t - 2y.  Its inputs were made at
// earlier steps: (y, x - 1) by itself at t - 1 (a register), (y - 1, x + 1)
// at t - 1, (y - 1, x) at t - 2 and (y - 1, x - 1) at t - 3 by the thread
// above, which keeps its last 4 pixels in a shared-memory ring (slot x & 3:
// at step t it writes slot (x + 2) & 3, which none of the three reads
// hits).  One __syncthreads a step orders a step's ring writes before the
// next step's reads.  Rows go in bands of up to 1024 threads; a band's
// first row reads the row above from the output the band before wrote
// (the add-green epilogue undone, which is exact), after the band's last
// barrier.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 1024;
constexpr uint32_t kBlack = 0xff000000u;

__device__ __forceinline__ uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

__device__ __forceinline__ int ch(uint32_t v, int s) { return (int)((v >> s) & 255u); }

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// L when the T-TL gradient is the smaller (the format's crossed names), else T.
__device__ __forceinline__ uint32_t select_pred(uint32_t l, uint32_t t, uint32_t tl) {
  int p_l = 0, p_t = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    p_l += abs(ch(t, s) - ch(tl, s));
    p_t += abs(ch(l, s) - ch(tl, s));
  }
  return p_l < p_t ? l : t;
}

__device__ __forceinline__ uint32_t clamp_add_sub_full(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) r |= (uint32_t)clip255(ch(l, s) + ch(t, s) - ch(tl, s)) << s;
  return r;
}

__device__ __forceinline__ uint32_t clamp_add_sub_half(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t ave = avg2(l, t);
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    const int a = ch(ave, s), d = a - ch(tl, s);
    r |= (uint32_t)clip255(a + d / 2) << s;  // division truncates toward zero
  }
  return r;
}

__device__ __forceinline__ uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tl,
                                            uint32_t tr) {
  switch (mode) {
    case 0: return kBlack;
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
    case 12: return clamp_add_sub_full(l, t, tl);
    case 13: return clamp_add_sub_half(l, t, tl);
    default: return 0u;
  }
}

// Byte-wise (x + p) mod 256.
__device__ __forceinline__ uint32_t add_pixels(uint32_t x, uint32_t p) {
  const uint32_t lo = ((x & 0x00ff00ffu) + (p & 0x00ff00ffu)) & 0x00ff00ffu;
  const uint32_t hi = (((x >> 8) & 0x00ff00ffu) + ((p >> 8) & 0x00ff00ffu)) & 0x00ff00ffu;
  return lo | (hi << 8);
}

// The add-green inverse (sign 1) or its own inverse, subtract-green (-1).
__device__ __forceinline__ uint32_t green(uint32_t v, int sign) {
  const uint32_t g = (v >> 8) & 255u;
  const uint32_t r = (((v >> 16) & 255u) + sign * g) & 255u;
  const uint32_t b = ((v & 255u) + sign * g) & 255u;
  return (v & 0xff00ff00u) | (r << 16) | b;
}

__global__ void __launch_bounds__(kMaxRows)
vp8l_inverse_kernel(const uint32_t* __restrict__ res, const uint32_t* __restrict__ mode_img,
                    uint32_t* __restrict__ out, int h, int w, int bits, int tw, int add_green) {
  __shared__ uint32_t ring[kMaxRows][4];  // each row's last 4 pixels, slot x & 3
  const size_t plane = (size_t)h * w;
  const uint32_t* rp = res + blockIdx.x * plane;
  uint32_t* op = out + blockIdx.x * plane;
  const int j = threadIdx.x;
  for (int y0 = 0; y0 < h; y0 += kMaxRows) {
    const int rows = min(kMaxRows, h - y0);
    const int y = y0 + j;
    const bool mine = j < rows;
    const uint32_t* rrow = rp + (size_t)y * w;
    const uint32_t* mrow = mode_img + (size_t)(y >> bits) * tw;
    // the row above, for the band's first row: the band before's output
    const uint32_t* above = op + (size_t)(y - 1) * w;
    uint32_t left = 0, first = 0;
    const int steps = w + 2 * (rows - 1);
    for (int t = 0; t < steps; t++) {
      const int x = t - 2 * j;
      if (mine && x >= 0 && x < w) {
        uint32_t pred;
        if (y == 0) {
          pred = x == 0 ? kBlack : left;
        } else {
          // T, TL, TR of the row above: the ring of the thread above, or
          // the output of the band before
          uint32_t tp, tl = 0, tr;
          if (j > 0) {
            tp = ring[j - 1][x & 3];
            if (x > 0) tl = ring[j - 1][(x - 1) & 3];
            tr = x + 1 < w ? ring[j - 1][(x + 1) & 3] : first;
          } else {
            const int s = add_green ? -1 : 1;
            tp = add_green ? green(above[x], s) : above[x];
            if (x > 0) tl = add_green ? green(above[x - 1], s) : above[x - 1];
            tr = x + 1 < w ? (add_green ? green(above[x + 1], s) : above[x + 1]) : first;
          }
          if (x == 0) {
            pred = tp;
          } else {
            const int mode = (int)((__ldg(mrow + (x >> bits)) >> 8) & 255u);
            pred = predict(mode, left, tp, tl, tr);
          }
        }
        const uint32_t px = add_pixels(__ldg(rrow + x), pred);
        ring[j][x & 3] = px;
        if (x == 0) first = px;
        left = px;
        op[(size_t)y * w + x] = add_green ? green(px, 1) : px;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Inverts B residual images (B, h, w) sharing the mode image (th, tw),
// tw = ceil(w / 2^bits), into `out` (B, h, w), on `stream`; `add_green`
// non-zero applies the add-green inverse to each pixel as it is stored.
// Returns the CUDA error of the launch (0 = accepted).
extern "C" int vp8l_inverse_launch(const uint32_t* res, const uint32_t* mode_img, uint32_t* out,
                                   int B, int h, int w, int bits, int add_green, void* stream) {
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  const int rows = h < kMaxRows ? h : kMaxRows;
  const int threads = (rows + 31) / 32 * 32;
  const int tw = (w + (1 << bits) - 1) >> bits;
  vp8l_inverse_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(res, mode_img, out, h, w, bits,
                                                               tw, add_green);
  return (int)cudaGetLastError();
}
