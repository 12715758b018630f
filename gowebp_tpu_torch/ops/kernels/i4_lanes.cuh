// Lane-parallel scoring of i4 candidates, for wavefront_search.cu's
// in-loop walk: one candidate (a B-mode on one 4x4 sub-block) per 16-lane
// segment, one lane per pixel or coefficient, N candidates of a segment
// together so that their shuffles go out back to back.  Same arithmetic,
// bit for bit, as i4_score.cuh's one-lane score_pred.

#pragma once
#include <cstdint>

#include "i4_score.cuh"
#include "vp8_dsp.cuh"
#include "wavefront_mb.cuh"

namespace vp8 {

// Raster index of zigzag position n, one nibble each (the inverse of
// inv_zigzag): lane n of a segment fetches position n's level from there.
constexpr unsigned long long kZigzagNibbles = 0xFEB7ADC963258410ull;
__device__ __forceinline__ int zigzag_lane(int n) {
  return (int)((kZigzagNibbles >> (4 * n)) & 15);
}

// Sums of N values over each 16-lane segment, in every lane of it.
template <int N>
__device__ __forceinline__ void seg_sum(int* v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
#pragma unroll
    for (int b = 0; b < N; b++) v[b] += __shfl_xor_sync(kFullMask, v[b], o);
}

// The 4x4 transforms with one output a lane and no selects on the data:
// lane (i, j) of a segment needs one output of each pass's 4-point
// butterfly, and that output is a weighted sum of the butterfly's two
// inputs P = d0 +- d3 and Q = d1 +- d2 (the sign by the output's parity),
// with lane-constant weights.  Same values as fdct_lanes / idct_lanes.

// Lane constants of one FDCT pass for output o (0-3): out = (P * w1 + Q *
// w2 + w3) >> sh, P = d0 + s * d3, Q = d1 + s * d2.
struct FdctPass {
  int s, w1, w2, w3, sh;
};
__device__ __forceinline__ FdctPass fdct_row_pass(int o) {  // fdct4x4's first pass
  return o == 0   ? FdctPass{1, 8, 8, 0, 0}
         : o == 1 ? FdctPass{-1, 5352, 2217, 1812, 9}
         : o == 2 ? FdctPass{1, 8, -8, 0, 0}
                  : FdctPass{-1, 2217, -5352, 937, 9};
}
__device__ __forceinline__ FdctPass fdct_col_pass(int o) {  // its second pass
  return o == 0   ? FdctPass{1, 1, 1, 7, 4}
         : o == 1 ? FdctPass{-1, 5352, 2217, 12000, 16}
         : o == 2 ? FdctPass{1, 1, -1, 7, 4}
                  : FdctPass{-1, 2217, -5352, 51000, 16};
}

// Residual element k -> raster coefficient k, for N blocks at once, in
// place (fdct4x4; the (b3 != 0) term of output row 1 included).
template <int N>
__device__ __forceinline__ void fdct_lean(int* x, int k) {
  const int i = k >> 2, j = k & 3;
  const FdctPass r = fdct_row_pass(j), c = fdct_col_pass(i);
  int d[N][4];
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(x[b], 4 * i + e);
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int P = d[b][0] + r.s * d[b][3], Q = d[b][1] + r.s * d[b][2];
    x[b] = (P * r.w1 + Q * r.w2 + r.w3) >> r.sh;
  }
#pragma unroll
  for (int b = 0; b < N; b++)
#pragma unroll
    for (int e = 0; e < 4; e++) d[b][e] = seg_get(x[b], 4 * e + j);
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int P = d[b][0] + c.s * d[b][3], Q = d[b][1] + c.s * d[b][2];
    x[b] = ((P * c.w1 + Q * c.w2 + c.w3) >> c.sh) + (i == 1 && P != 0);
  }
}

// Dequantized raster coefficient k -> residual element k, pre-clip, for N
// blocks at once, in place (idct4x4): output o of a pass is (d0 +- d2) +-
// mul1(X) +- mul2(Y), with X, Y = d1, d3 for o = 0, 3 and d3, d1 for o = 1,
// 2 (so the a + e, b + c, b - c, a - e of idct4x4).  Each lane fetches its
// own X and Y by shuffle, so nothing selects on the data.
template <int N>
__device__ __forceinline__ void idct_lean(int* x, int k) {
  const int i = k >> 2, j = k & 3;
  const bool xi = i == 0 || i == 3, xj = j == 0 || j == 3;
  const int s0i = xi ? 1 : -1, sai = i == 0 || i == 2 ? 1 : -1, sbi = i <= 1 ? 1 : -1;
  const int s0j = xj ? 1 : -1, saj = j == 0 || j == 2 ? 1 : -1, sbj = j <= 1 ? 1 : -1;
  // column pass: column j's rows 0, 2, then X and Y; row pass: row i's
  const int c0 = j, c2 = 8 + j, cx = (xi ? 4 : 12) + j, cy = (xi ? 12 : 4) + j;
  const int r0 = 4 * i, r2 = 4 * i + 2, rx = 4 * i + (xj ? 1 : 3), ry = 4 * i + (xj ? 3 : 1);
  int d[N][4];
#pragma unroll
  for (int b = 0; b < N; b++) {
    d[b][0] = seg_get(x[b], c0);
    d[b][1] = seg_get(x[b], c2);
    d[b][2] = seg_get(x[b], cx);
    d[b][3] = seg_get(x[b], cy);
  }
#pragma unroll
  for (int b = 0; b < N; b++)
    x[b] = d[b][0] + s0i * d[b][1] + sai * mul1(d[b][2]) + sbi * mul2(d[b][3]);
#pragma unroll
  for (int b = 0; b < N; b++) {
    d[b][0] = seg_get(x[b], r0);
    d[b][1] = seg_get(x[b], r2);
    d[b][2] = seg_get(x[b], rx);
    d[b][3] = seg_get(x[b], ry);
  }
#pragma unroll
  for (int b = 0; b < N; b++)
    x[b] = (d[b][0] + 4 + s0j * d[b][1] + saj * mul1(d[b][2]) + sbj * mul2(d[b][3])) >> 3;
}

// Token rate (1/256 bit) of N blocks with ctx0 = 1, rate_walk's rules by
// position: lane n of a segment charges zigzag position n, given the
// levels of positions n (lz[b]) and n - 1 (lp[b]; any value at n = 0).
// The segment's ballot of the non-zero positions gives `last` (kFirst - 1
// for an empty block).  A lane in kFirst..last adds the p0(1) term where n
// is a decision point (n == kFirst or a non-zero before it) and the p1 and
// value terms, with the context of the level before it; lane last + 1
// (none when last == 15) adds the end-of-block p0(0) term, under the same
// context rule: ctx0 when it is kFirst, else after a non-zero.  rate[b]
// gets the segment's sum in every lane.  Straight-line code: every load
// is made and every choice is a select, so the N blocks' ballots and loads
// go out together.
template <int N, int kFirst>
__device__ __forceinline__ void rate_positions(const int* lz, const int* lp, int n,
                                               const Tables& t, int* rate) {
  int last[N];
#pragma unroll
  for (int b = 0; b < N; b++) {
    const unsigned mask = seg_ballot(lz[b] != 0 && n >= kFirst);
    last[b] = mask ? 31 - __clz(mask) : kFirst - 1;
  }
  int4 pp[N];
  int val[N];
  bool prev_nz[N];
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int a = lz[b] < 0 ? -lz[b] : lz[b], ap = lp[b] < 0 ? -lp[b] : lp[b];
    prev_nz[b] = n > kFirst && ap != 0;
    const int ctx = n == kFirst ? 1 : (prev_nz[b] ? (ap == 1 ? 1 : 2) : 0);
    const int row = 3 * n + ctx;
    pp[b] = t.pp[row];
    val[b] = t.val[row * 68 + (a > 67 ? 67 : a)];
  }
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int charge = (n == kFirst || prev_nz[b] ? pp[b].y : 0) +
                       (lz[b] != 0 ? pp[b].w + val[b] + 256 : pp[b].z);
    const bool active = n >= kFirst && n <= last[b];
    rate[b] = active ? charge : (n == last[b] + 1 ? pp[b].x : 0);
  }
  seg_sum<N>(rate);
}

// rate_positions of N blocks whose raster levels sit on the lanes (lane k
// of a segment holds raster level k of block b in lv[b]): lane n fetches
// the levels of positions n and n - 1 by shuffle from their raster lanes.
template <int N, int kFirst>
__device__ __forceinline__ void rate_lanes(const int* lv, int n, const Tables& t, int* rate) {
  const int here = zigzag_lane(n), before = zigzag_lane(n > 0 ? n - 1 : 0);
  int lz[N], lp[N];
#pragma unroll
  for (int b = 0; b < N; b++) {
    lz[b] = seg_get(lv[b], here);
    lp[b] = seg_get(lv[b], before);
  }
  rate_positions<N, kFirst>(lz, lp, n, t, rate);
}

// rate_positions of N blocks whose zigzag levels sit in shared memory,
// block b at zz + 16 * b: lane n loads positions n and n - 1.
template <int N, int kFirst>
__device__ __forceinline__ void rate_zigzag(const int16_t* zz, int n, const Tables& t,
                                            int* rate) {
  int lz[N], lp[N];
#pragma unroll
  for (int b = 0; b < N; b++) {
    lz[b] = zz[16 * b + n];
    lp[b] = zz[16 * b + (n > 0 ? n - 1 : 0)];
  }
  rate_positions<N, kFirst>(lz, lp, n, t, rate);
}

// 1/256-bit header cost of B-mode m (kMode4Bits256[m], all multiples of
// 64), from a constant: lanes of different modes read no memory.
constexpr unsigned long long kMode4Bits64ths = 0x1F083E0F63164ull;
__device__ __forceinline__ int mode4_bits(int m) {
  return (int)((kMode4Bits64ths >> (5 * m)) & 31) << 6;
}

// A prediction table entry decoded for the lanes: the byte offsets in the
// scratch of pred_entry's three features and its op byte.
__device__ __forceinline__ int4 pred_lane_entry(int m, int k) {
  const unsigned e = pred_entry(m, k);
  return make_int4(4 * (int)(e & 255), 4 * (int)((e >> 8) & 255), 4 * (int)((e >> 16) & 255),
                   (int)(e >> 24));
}

// Lane-parallel B-mode prediction from a decoded entry (pred_lane_entry)
// and the sub-block's DC value: pred_b4_lane's value, without its branch.
// `s` points at the sub-block's context corner in the scratch.
__device__ __forceinline__ int pred_lane(int4 e, const unsigned char* s, int dc) {
  const int z0 = *reinterpret_cast<const int*>(s + e.x);
  const int z1 = *reinterpret_cast<const int*>(s + e.y);
  const int z2 = *reinterpret_cast<const int*>(s + e.z);
  const int op = e.w, sh = (op >> 4) & 3;
  const int v = clip8((z0 + (op & 3) * z1 + (((op >> 2) & 3) - 1) * z2 + sh) >> sh);
  return (op & 64) ? dc : v;
}

// Search keys of N candidates on one sub-block, modes m0 .. m0 + N - 1, on
// this lane's segment: lane k predicts pixel k from the scratch `sy`
// (context corner at `base`; ptab holds pred_lane_entry(m, k) at 16 * m +
// k), takes src (its source pixel) minus the prediction through the FDCT
// and quantization (lv[j]: raster level k), the rate, dequantization, IDCT
// and recon (rec[j]: pixel k), and the SSE.  The RD cost is SSE + (pen *
// (rate + mode bits)) >> 16, below 2^22 (pen < 2^19, rate + mode bits <
// 2^18, SSE < 2^20), so key[j] = cost << 4 | mode orders the candidates
// by (cost, mode): the least key is the first minimum.  All 32 lanes call
// it.
//
// refine(x, lv), called with the coefficients in x and the levels in lv,
// may change the levels before the rate and the dequantization
// (wavefront_search.cu's trellis form).
template <int N, typename Refine>
__device__ __forceinline__ void score_lanes(const int4* ptab, int m0, int k, const int* sy,
                                            int base, int src, const Quant& q, const Tables& t,
                                            int* key, int* rec, int* lv, Refine refine) {
  int dc = 4;  // the DC prediction: (top 4 + left 4 + 4) >> 3
#pragma unroll
  for (int i = 0; i < 4; i++) dc += sy[base + 1 + i] + sy[base + (1 + i) * kSW];
  dc >>= 3;
  const unsigned char* corner = reinterpret_cast<const unsigned char*>(sy + base);
  int p[N], x[N], rate[N];
#pragma unroll
  for (int j = 0; j < N; j++) {
    p[j] = pred_lane(ptab[16 * (m0 + j) + k], corner, dc);
    x[j] = src - p[j];
  }
  fdct_lean<N>(x, k);
#pragma unroll
  for (int j = 0; j < N; j++)
    lv[j] = quant_lane(x[j], k, q.iq_dc, q.iq_ac, kBiasY1Dc, kBiasY1Ac, false);
  refine(x, lv);
#pragma unroll
  for (int j = 0; j < N; j++) x[j] = lv[j] * (k == 0 ? q.q_dc : q.q_ac);
  rate_lanes<N, 0>(lv, k, t, rate);
  idct_lean<N>(x, k);
#pragma unroll
  for (int j = 0; j < N; j++) {
    rec[j] = clip8(p[j] + x[j]);
    const int e = src - rec[j];
    key[j] = e * e;
  }
  seg_sum<N>(key);
#pragma unroll
  for (int j = 0; j < N; j++) {
    const int cost = key[j] + mul_shr16(q.pen, rate[j] + mode4_bits(m0 + j));
    key[j] = cost << 4 | (m0 + j);
  }
}

// Trellis quantization of one block by one lane (the host encoder's
// trellis_refine, wavefront_search.cu's trellis form): each non-zero
// zigzag level l0 of lv (in place, positions kFirst..15) is kept or
// lowered to l0 - 1 (never to 0) by the least distortion (|c| - v q)^2 +
// lam * token rate over the whole block, c its raster coefficient in cf, q
// dc_q at position 0 and ac_q elsewhere, the rate the exact token
// grammar's (rate_walk's rules, ctx0 = 1) on the position tables t.
// A DP over positions with 2 states, the candidate taken at the last
// non-zero so far (its score, the context it leaves, the rate since it:
// the continue bit and the zero run), all in registers: the loops are
// unrolled and the choices a bit per position and candidate.  Scores are
// int64; ties keep the unlowered level and the lower predecessor.
template <int kFirst>
__device__ __forceinline__ void trellis_refine(int16_t* lv, const int* cf, int dc_q, int ac_q,
                                               int lam, const Tables& t) {
  constexpr long long kInf = 1ll << 60;
  long long s0 = 0, s1 = kInf;    // the scores of the two states
  int c0 = 1, c1 = 1, a0 = 0, a1 = 0, nxt = kFirst;  // contexts, run rates, last nz + 1
  unsigned m0 = 0, m1 = 0;        // bit n: candidate 0 / 1 at n came from state 1
  const long long L = lam;
#pragma unroll
  for (int n = kFirst; n < 16; n++) {
    const int l = lv[n], v = l < 0 ? -l : l;
    const bool after = nxt == n;
    const int r0 = 3 * n + (after ? c0 : 0), r1 = 3 * n + (after ? c1 : 0);
    const int4 P0 = t.pp[r0], P1 = t.pp[r1];
    if (after) {
      a0 = P0.y;
      a1 = P1.y;
    }
    if (v == 0) {
      a0 += P0.z;
      a1 += P1.z;
      continue;
    }
    const int raw = cf[zigzag_lane(n)], araw = raw < 0 ? -raw : raw;
    const int qs = n == 0 ? dc_q : ac_q;
    const long long b0 = s0 + (long long)(a0 + P0.w + 256) * L;
    const long long b1 = s1 + (long long)(a1 + P1.w + 256) * L;
    long long ns[2];
    unsigned pick[2];
#pragma unroll
    for (int c = 0; c < 2; c++) {
      const int w = v - c, wv = w > 67 ? 67 : w;
      const long long e = araw - w * qs;
      const long long t0 = b0 + t.val[r0 * 68 + wv] * L + e * e;
      const long long t1 = s1 >= kInf ? kInf : b1 + t.val[r1 * 68 + wv] * L + e * e;
      pick[c] = t1 < t0;
      ns[c] = (c == 1 && w < 1) ? kInf : (pick[c] ? t1 : t0);
    }
    m0 |= pick[0] << n;
    m1 |= pick[1] << n;
    s0 = ns[0];
    s1 = ns[1];
    c0 = v == 1 ? 1 : 2;
    c1 = v - 1 == 1 ? 1 : 2;
    nxt = n + 1;
  }
  if (nxt <= 15) {  // the end-of-block bit after the last non-zero
    s0 += t.pp[3 * nxt + c0].x * L;
    if (s1 < kInf) s1 += t.pp[3 * nxt + c1].x * L;
  }
  unsigned cur = s1 < s0;
#pragma unroll
  for (int n = 15; n >= kFirst; n--) {
    const int l = lv[n];
    if (l == 0) continue;
    const int w = (l < 0 ? -l : l) - (int)cur;
    lv[n] = (int16_t)(l < 0 ? -w : w);
    cur = ((cur ? m1 : m0) >> n) & 1;
  }
}

}  // namespace vp8
