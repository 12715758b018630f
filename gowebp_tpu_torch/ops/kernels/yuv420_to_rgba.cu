// Fused fancy chroma upsampling + BT.601 YUV -> RGBA, the decode's last
// device stage.
//
// Replaces the TPU kernel gowebp_tpu/ops/pallas/decode_post.py
// (yuv420_to_rgba_pallas -> _post_kernel).  That kernel's shape (a
// 16-row luma band split into even/odd columns, a 10-row chroma window,
// lane rolls, and its H % 16 / even-W limits) follows the TPU's tiling;
// none of it carries over.  Here one thread writes one aligned 2x2 quad
// of output pixels, rows 2i..2i+1 and columns 2m..2m+1, from the 3x3
// chroma neighbourhood rows i-1..i+1, columns m-1..m+1 of each chroma
// plane, read straight from the MB-padded uint8 planes of the
// reconstruction (any row stride) and cropped to the visible H x W.
//
// Every output pixel is one formula, px(N_a, N_b, F_a, F_b): N is the
// nearer chroma row, F the farther, a the nearer column, b the farther.
// The edge rules are index clamps: row 0 pairs chroma row 0 with itself,
// an even height's last row pairs the last chroma row with itself, and
// column 0 (and an even width's column W-1) pairs a chroma column with
// itself, where px reduces to libwebp's 3:1 vertical-only tap
// (3N + F + 2) >> 2.  Odd H and W simply stop at the last pixel.
// With `fancy` 0 (the decoder's no_fancy_upsampling) every pixel of the
// quad takes chroma sample (i, m) itself: nearest upsampling.
//
// Bound on the card: bytes.  Per output pixel it reads 1.5 bytes of YUV
// (plus 1 of alpha when given) and writes 4, against ~60 integer ops;
// the chroma taps re-read by neighbouring threads hit L1.  Stores are
// uchar4, consecutive threads on consecutive pixel pairs of a row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockX = 32;  // column pairs per block
constexpr int kBlockY = 8;   // row pairs per block

__device__ __forceinline__ int px(int na, int nb, int fa, int fb) {
  const int avg = na + nb + fa + fb + 8;
  return (((avg + 2 * (nb + fa)) >> 3) + na) >> 1;
}

__device__ __forceinline__ int clip_rgb(int x) {
  x = x < 0 ? 0 : (x > (256 << 6) - 1 ? (256 << 6) - 1 : x);
  return x >> 6;
}

__device__ __forceinline__ uchar4 to_rgba(int y, int u, int v, int a) {
  const int yy = (y * 19077) >> 8;
  const int r = clip_rgb(yy + ((v * 26149) >> 8) - 14234);
  const int g = clip_rgb(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
  const int b = clip_rgb(yy + ((u * 33050) >> 8) - 17685);
  return make_uchar4((unsigned char)r, (unsigned char)g, (unsigned char)b,
                     (unsigned char)a);
}

// Upsampled chroma of the quad: c[dr][dc] for output pixel (2i+dr, 2m+dc)
// from the 3x3 taps t[row][col] (rows i-1, i, i+1; cols m-1, m, m+1,
// already clamped).  Row 2i is nearer row i with row i-1 farther; row
// 2i+1 nearer row i with row i+1 farther.  Column 2m is nearer column m
// with m-1 farther; column 2m+1 nearer m with m+1 farther.
__device__ __forceinline__ void upsample_quad(const int t[3][3], int c[2][2]) {
  c[0][0] = px(t[1][1], t[1][0], t[0][1], t[0][0]);
  c[0][1] = px(t[1][1], t[1][2], t[0][1], t[0][2]);
  c[1][0] = px(t[1][1], t[1][0], t[2][1], t[2][0]);
  c[1][1] = px(t[1][1], t[1][2], t[2][1], t[2][2]);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
yuv420_to_rgba_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                      const uint8_t* __restrict__ v, const uint8_t* __restrict__ alpha,
                      int H, int W, int y_rows, int y_stride, int c_rows, int c_stride,
                      int fancy, uint8_t* __restrict__ out) {
  const int m = blockIdx.x * kBlockX + threadIdx.x;  // column pair
  const int i = blockIdx.y * kBlockY + threadIdx.y;  // row pair
  const int b = blockIdx.z;
  const int h2 = (H + 1) >> 1, w2 = (W + 1) >> 1;
  if (m >= w2 || i >= h2) return;

  const int rows[3] = {i > 0 ? i - 1 : 0, i, i + 1 < h2 ? i + 1 : h2 - 1};
  const int cols[3] = {m > 0 ? m - 1 : 0, m, m + 1 < w2 ? m + 1 : w2 - 1};
  const size_t cbase = (size_t)b * c_rows * c_stride;
  int tu[3][3], tv[3][3];
#pragma unroll
  for (int r = 0; r < 3; r++) {
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const size_t o = cbase + (size_t)rows[r] * c_stride + cols[k];
      tu[r][k] = __ldg(u + o);
      tv[r][k] = __ldg(v + o);
    }
  }
  int cu[2][2], cv[2][2];
  if (fancy) {
    upsample_quad(tu, cu);
    upsample_quad(tv, cv);
  } else {
#pragma unroll
    for (int r = 0; r < 4; r++) {
      cu[r >> 1][r & 1] = tu[1][1];
      cv[r >> 1][r & 1] = tv[1][1];
    }
  }

  const size_t ybase = (size_t)b * y_rows * y_stride;
#pragma unroll
  for (int dr = 0; dr < 2; dr++) {
    const int row = 2 * i + dr;
    if (row >= H) break;
    const size_t orow = ((size_t)b * H + row) * W;
#pragma unroll
    for (int dc = 0; dc < 2; dc++) {
      const int col = 2 * m + dc;
      if (col >= W) break;
      const int yv = __ldg(y + ybase + (size_t)row * y_stride + col);
      const int av = alpha != nullptr ? __ldg(alpha + orow + col) : 255;
      reinterpret_cast<uchar4*>(out)[orow + col] =
          to_rgba(yv, cu[dr][dc], cv[dr][dc], av);
    }
  }
}

}  // namespace

// y: (B, y_rows, y_stride) uint8; u, v: (B, c_rows, c_stride) uint8;
// alpha: (B, H, W) uint8 or null; fancy: 1 fancy, 0 nearest chroma
// upsampling; out: (B, H, W, 4) uint8.  The visible
// H x W must fit the planes: y_rows >= H, y_stride >= W, c_rows >=
// (H+1)/2, c_stride >= (W+1)/2 (the wrapper checks).
extern "C" int yuv420_to_rgba_launch(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                     const uint8_t* alpha, int B, int H, int W, int y_rows,
                                     int y_stride, int c_rows, int c_stride, int fancy,
                                     uint8_t* out, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((((W + 1) >> 1) + kBlockX - 1) / kBlockX,
                  (((H + 1) >> 1) + kBlockY - 1) / kBlockY, B);
  yuv420_to_rgba_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      y, u, v, alpha, H, W, y_rows, y_stride, c_rows, c_stride, fancy, out);
  return (int)cudaGetLastError();
}
