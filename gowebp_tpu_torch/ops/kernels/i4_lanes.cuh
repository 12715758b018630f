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

// The trellis's infinite score, of a state no path reaches (the lowered
// level of |l| = 1; state 1 before the first non-zero).  A finite score
// stays below 2^55 (16 positions of distortion (|c| - w q)^2 < 2^47 and
// lam * rate < 2^53 for int32 lambdas, 16-bit table entries, |c| < 2^16,
// w < 2^11 and q < 2^12), so with INF = 2^58 a sum of 16 scores, each
// finite or infinite, stays below 2^63: the min-plus products below need
// no saturation, and every infinite sum stays at INF or above.
constexpr long long kTrellisInf = 1ll << 58;

// A 2x2 min-plus matrix: x[s][c] the cost of going from state s (the
// level kept, or lowered by one) at one non-zero position to candidate c
// at a later one.
struct MinPlus {
  long long x00, x01, x10, x11;
};

// a then b: the product in the (min, +) semiring.
__device__ __forceinline__ MinPlus minplus(const MinPlus& a, const MinPlus& b) {
  return {min(a.x00 + b.x00, a.x01 + b.x10), min(a.x00 + b.x01, a.x01 + b.x11),
          min(a.x10 + b.x00, a.x11 + b.x10), min(a.x10 + b.x01, a.x11 + b.x11)};
}

// The matrix of the lane d below in this lane's segment (its own below d).
__device__ __forceinline__ MinPlus shfl_up16(const MinPlus& a, int d) {
  return {__shfl_up_sync(kFullMask, a.x00, d, 16), __shfl_up_sync(kFullMask, a.x01, d, 16),
          __shfl_up_sync(kFullMask, a.x10, d, 16), __shfl_up_sync(kFullMask, a.x11, d, 16)};
}

// One block's parameters in trellis_lanes: its rate table (an index into
// the kernel's tables and their zero-run sums), its first position, and
// the steps of position 0 and of the rest.
struct TrellisType {
  int table, first, dc_q, ac_q;
};

// a * b as int64, one 32 x 32 -> 64-bit multiply.
__device__ __forceinline__ long long mul_wide(int a, int b) {
  long long r;
  asm("mul.wide.s32 %0, %1, %2;" : "=l"(r) : "r"(a), "r"(b));
  return r;
}

// What a lane holds of one packing round of trellis_lanes: its non-zero
// (rank i of a block whose kb non-zeros sit on lanes o ..), that
// non-zero's matrix m, (M[1][c] - M[0][c]) / lam as g0, g1, and the
// end-of-block bit's costs after it under either state.
struct TrellisSlot {
  MinPlus m;
  int i, kb, o, g0, g1, eob0, eob1;
  bool on;
};

// Trellis quantization of N blocks on each 16-lane segment (the host
// encoder's trellis_refine, wavefront_search.cu's trellis form): each
// non-zero zigzag level l0 of block b at positions ty[b].first..15 is
// kept or lowered to l0 - 1 (never to 0) by the least distortion (|c| - v
// q)^2 + lam * token rate over the whole block, c its coefficient, q the
// block's dc_q at position 0 and ac_q elsewhere, the rate the exact token
// grammar's (rate_walk's rules, ctx0 = 1) on the position tables
// T[ty[b].table]; zrun[16 i + n] sums the zero-token costs T[i].pp[3 m].z
// of positions m < n.  Lane k of a segment holds raster coefficient k and
// raster level k of block b in cf[b] and lv[b]; lv is refined in place.
//
// The serial DP (one pass over the positions, two states) as a scan.
// Between consecutive non-zeros p < n of a block the DP's step is a 2x2
// min-plus matrix M_n, M_n[s][c] = (run(p -> n | ctx_s) + pp[r_s].w + 256
// + val[r_s][min(|l_n| - c, 67)]) * lam + (|c_n| - (|l_n| - c) q_n)^2,
// ctx_s the context state s leaves at p (1 after a level 1, else 2), run
// the continue bit at p + 1 under ctx_s plus the zero tokens up to n - 1
// (context 0 after the first), r_s = 3 n + (n == p + 1 ? ctx_s : 0);
// M_n[s][1] = INF when |l_n| = 1; zero positions change nothing; the
// first non-zero's predecessor is a virtual one at first - 1 with context
// 1 and scores (0, INF).  The blocks' non-zeros are packed onto the
// segment's lanes, block after block in zigzag order (a block that does
// not fit starts another round), so one lane builds one non-zero's
// matrix, from the level and coefficient it fetches by shuffle; two
// rounds run side by side, as independent chains.  A segmented
// Kogge-Stone scan (ceil(log2) of the most non-zeros a block has, at most
// 4 shuffle steps) gives each lane the serial loop's scores
// at its non-zero and, by one more shuffle, at its predecessor; the
// choice bits are the serial form's strict t1 < t0 (ties keep the
// unlowered level and the lower predecessor), by the state difference:
// (M[1][c] - M[0][c]) is an int times lam.  The last non-zero adds the
// end-of-block bit for the final state, and each lane backtracks to its
// own state in bit-parallel form (the lowest constant choice above it,
// then the parity of the negating ones between), from the ballots.  Then
// each lane lowers its own raster levels.  Bit for bit the serial DP's
// levels, ties included: min-plus products of these int64 scores are
// exact and associative.
template <int N>
__device__ __forceinline__ void trellis_lanes(const int* cf, int* lv, int k, int lam,
                                              const TrellisType* ty, const Tables* T,
                                              const int* zrun) {
  constexpr long long kInf = kTrellisInf;
  // each block's non-zero positions, and their count
  unsigned nz[N];
  int cnt[N];
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int l = seg_get(lv[b], zigzag_lane(k));
    nz[b] = seg_ballot(l != 0 && k >= ty[b].first);
    cnt[b] = __popc(nz[b]);
  }
  // rounds of up to 16 non-zeros, block b's on lanes off[b] ..
  int rnd[N], off[N], rounds = 1;
  {
    int used = 0;
#pragma unroll
    for (int b = 0; b < N; b++) {
      if (used + cnt[b] > 16) {
        rounds++;
        used = 0;
      }
      rnd[b] = rounds - 1;
      off[b] = used;
      used += cnt[b];
    }
  }

  // round r's non-zero on this lane, its matrix and costs; kmax gets the
  // round's most non-zeros in a block
  auto setup = [&](int r, TrellisSlot& s, int& kmax) {
    bool hit[N];
    unsigned mask = 0;
    int o = 0, kb = 0, table = 0, first = 0, dc_q = 0, ac_q = 0;
#pragma unroll
    for (int b = 0; b < N; b++) {  // the block whose lanes hold k, if any
      hit[b] = rnd[b] == r && (unsigned)(k - off[b]) < (unsigned)cnt[b];
      kmax = max(kmax, rnd[b] == r ? cnt[b] : 0);
      mask |= hit[b] ? nz[b] : 0u;
      o |= hit[b] ? off[b] : 0;
      kb |= hit[b] ? cnt[b] : 0;
      table |= hit[b] ? ty[b].table : 0;
      first |= hit[b] ? ty[b].first : 0;
      dc_q |= hit[b] ? ty[b].dc_q : 0;
      ac_q |= hit[b] ? ty[b].ac_q : 0;
    }
    s.on = kb > 0;
    s.kb = kb;
    s.o = o;
    s.i = s.on ? k - o : 0;
    int n = 0;  // its position: the i-th set bit of the mask
    {
      unsigned mm = mask;
      int rr = s.i;
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1) {
        const int c = __popc(mm & ((1u << w) - 1));
        if (rr >= c) {
          rr -= c;
          n += w;
          mm >>= w;
        }
      }
    }
    n &= 15;
    int l = 0, c = 0;
    const int src = zigzag_lane(n);
#pragma unroll
    for (int b = 0; b < N; b++) {
      const int lb = seg_get(lv[b], src), cb = seg_get(cf[b], src);
      l |= hit[b] ? lb : 0;
      c |= hit[b] ? cb : 0;
    }
    const int w = l < 0 ? -l : l, ac = c < 0 ? -c : c;
    const Tables& t = T[table];
    const int e = 3 * (n < 15 ? n + 1 : 15);  // the end-of-block bit after n
    s.eob0 = n < 15 ? t.pp[e + (w == 1 ? 1 : 2)].x : 0;
    s.eob1 = n < 15 ? t.pp[e + (w == 2 ? 1 : 2)].x : 0;
    // the predecessor: the lane below in the same block, or the virtual one
    const int pn = __shfl_up_sync(kFullMask, n, 1, 16), pw = __shfl_up_sync(kFullMask, w, 1, 16);
    const int p = s.i == 0 ? first - 1 : pn;
    const int ctx0 = s.i == 0 || pw == 1 ? 1 : 2, ctx1 = s.i == 0 || pw == 2 ? 1 : 2;
    const int* z = zrun + 16 * table;
    const bool adj = n == p + 1;
    const int4 Q0 = t.pp[3 * (p + 1) + ctx0], Q1 = t.pp[3 * (p + 1) + ctx1], Rn = t.pp[3 * n];
    const int run = z[n] - z[min(p + 2, 15)];  // zero tokens p + 2 .. n - 1
    const int base0 = Q0.y + (adj ? Q0.w : Q0.z + run + Rn.w) + 256;
    const int base1 = Q1.y + (adj ? Q1.w : Q1.z + run + Rn.w) + 256;
    const int r0 = 68 * (3 * n + (adj ? ctx0 : 0)), r1 = 68 * (3 * n + (adj ? ctx1 : 0));
    const int h0 = w > 67 ? 67 : w, h1 = w - 1 > 67 ? 67 : (w < 1 ? 0 : w - 1);
    const int qs = n == 0 ? dc_q : ac_q;
    const int e0 = ac - w * qs, e1 = ac - (w - 1) * qs;
    const long long d0 = mul_wide(e0, e0), d1 = mul_wide(e1, e1);
    const int u00 = base0 + t.val[r0 + h0], u01 = base0 + t.val[r0 + h1];
    const int u10 = base1 + t.val[r1 + h0], u11 = base1 + t.val[r1 + h1];
    // M_n (the identity off the non-zeros), and (M[1][c] - M[0][c]) / lam
    s.m.x00 = s.on ? mul_wide(u00, lam) + d0 : 0;
    s.m.x01 = s.on && w > 1 ? mul_wide(u01, lam) + d1 : kInf;
    s.m.x10 = s.on ? mul_wide(u10, lam) + d0 : kInf;
    s.m.x11 = !s.on ? 0 : w > 1 ? mul_wide(u11, lam) + d1 : kInf;
    s.g0 = u10 - u00;
    s.g1 = u11 - u01;
  };

  // after the scan: the segment's ballot of the lowered non-zeros
  auto finish = [&](const TrellisSlot& s) {
    // the scores at the predecessor, and the choices: candidate c came
    // from state 1 when s1 + M[1][c] < s0 + M[0][c] (never for an infinite
    // s1, as the serial form's t1 = INF is never below t0)
    long long s0 = __shfl_up_sync(kFullMask, s.m.x00, 1, 16);
    long long s1 = __shfl_up_sync(kFullMask, s.m.x01, 1, 16);
    if (s.i == 0) {
      s0 = 0;
      s1 = kInf;
    }
    const unsigned kmask = (1u << s.kb) - 1;
    const unsigned P0 = (seg_ballot(s.on && mul_wide(s.g0, lam) < s0 - s1) >> s.o) & kmask;
    const unsigned P1 = (seg_ballot(s.on && mul_wide(s.g1, lam) < s0 - s1) >> s.o) & kmask;
    // the final state: the last non-zero's scores with the end-of-block
    // bit after it (none at 15)
    const long long f0 = s.m.x00 + mul_wide(s.eob0, lam), f1 = s.m.x01 + mul_wide(s.eob1, lam);
    const unsigned fin = seg_ballot(s.on && s.i == s.kb - 1 && f1 < f0);
    // this non-zero's state: non-zero j's choices map the state at j to
    // the state at j - 1, so the state at i is those of i + 1 .. kb - 1
    // applied to the final one: the lowest constant choice above i (or
    // the final state) flipped by each negating choice between
    const unsigned above = kmask & ~((2u << s.i) - 1);
    const unsigned cst = ~(P0 ^ P1) & above, neg = P0 & ~P1 & above;
    const int cp = cst ? __ffs(cst) - 1 : s.kb;
    const unsigned from = cst ? (P0 >> cp) & 1 : s.kb ? (fin >> (s.o + s.kb - 1)) & 1 : 0;
    return seg_ballot(s.on && ((from ^ __popc(neg & ((1u << cp) - 1))) & 1));
  };

  unsigned st[N];  // block b's lowered non-zeros, bit i for its i-th
#pragma unroll
  for (int b = 0; b < N; b++) st[b] = 0;
  const int R = max(rounds, __shfl_xor_sync(kFullMask, rounds, 16));
  for (int r = 0; r < R; r += 2) {
    TrellisSlot a, b2;
    int kmax = 1;
    setup(r, a, kmax);
    setup(r + 1, b2, kmax);
    // inclusive prefix products over each block's non-zeros
    kmax = max(kmax, __shfl_xor_sync(kFullMask, kmax, 16));
    for (int d = 1; d < kmax; d <<= 1) {
      const MinPlus oa = minplus(shfl_up16(a.m, d), a.m);
      const MinPlus ob = minplus(shfl_up16(b2.m, d), b2.m);
      if (a.i >= d) a.m = oa;
      if (b2.i >= d) b2.m = ob;
    }
    const unsigned low0 = finish(a), low1 = finish(b2);
#pragma unroll
    for (int b = 0; b < N; b++) {
      const unsigned km = (1u << cnt[b]) - 1;
      if (rnd[b] == r) st[b] = (low0 >> off[b]) & km;
      if (rnd[b] == r + 1) st[b] = (low1 >> off[b]) & km;
    }
  }
  // each lane lowers its raster levels by their positions' states
  const int pos = inv_zigzag(k);
#pragma unroll
  for (int b = 0; b < N; b++) {
    const int down = (int)((nz[b] >> pos) & (st[b] >> __popc(nz[b] & ((1u << pos) - 1)))) & 1;
    lv[b] += lv[b] < 0 ? down : -down;
  }
}

}  // namespace vp8
