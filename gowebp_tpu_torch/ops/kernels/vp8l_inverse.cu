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
// What bounds it.  The bytes (each residual read once, each pixel written
// once) or the few dozen operations a pixel, whichever is larger; but the
// recurrence is serial: pixel (y, x) needs (y, x - 1), (y - 1, x + 1) and
// what those need, so an image is a chain of w + 2 (h - 1) dependent
// steps, and steps x the least time of a step is a floor the bound does
// not see.  A step is a shuffle, the candidates' longest path from L, the
// table's store and read and the byte-wise add; and every step issues all
// 14 predictors for its lane, mostly half-rate integer instructions.
//
// The design, against what held the one-block-an-image kernel back:
//   1. No block barrier a step.  A warp owns kRows = 32 consecutive rows,
//      lane l row 32 g + l, skewed by kSkew = 2: at warp step s lane l
//      takes x = s - 2 l.  Lane l - 1 made (y - 1, x + 1) at step s - 1,
//      (y - 1, x) at s - 2 and (y - 1, x - 1) at s - 3, so one
//      __shfl_up_sync a step of the pixel each lane just made, and the last
//      three values received kept in registers, give TR, T and TL; L is the
//      lane's own last pixel.  Every lane stays in the loop to the warp's
//      last step, so the shuffle's mask stays full; lanes off the image only
//      pass values along.
//   2. Row groups pipelined, not banded.  Lane 0 of group g > 0 reads row
//      32 g - 1, which lane 31 of group g - 1 publishes column by column as
//      it makes it, into an edge row of 64-bit words (the pixel, and a mark
//      in the high half; the wrapper zeroes the rows).  The mark travels in
//      the same word as the pixel, so a word is published by its own
//      relaxed store, with no fence on the producer's chain: a 64-bit
//      aligned word is written and read whole, so a word read with its
//      mark set holds its pixel, and a word read before its store lands
//      reads as unmarked.  The consumer copies the words of each iteration
//      (4 steps) kEdgeAhead iterations ahead into a ring in shared memory
//      (cp.async, 16 bytes at a time, in cp.async groups of their own,
//      interleaved with the residuals'), checks their marks at the
//      iteration's head, and reads a word found unmarked again with
//      relaxed loads until it is marked.  A group starts (and makes its
//      first copies) once the group above has published 4 kEdgeAhead + 1
//      columns, so the depth is w + 2 (h - 1) steps plus about that many
//      columns and a store's latency a group boundary, for any height.
//   3. An image spread over SMs.  A CTA holds up to kMaxWarps warps, as few
//      as let one CTA an SM (a shared-memory reserve keeps it alone) hold
//      every warp: B=8 at 1024x1024 runs 128 CTAs of 2 warps, one 4096x4096
//      image 128 of one.  A warp's step is bound by its own issue and its
//      SM's memory pipe, so warps sharing an SM slow each other (measured:
//      4 and 8 warps an SM against 1-2).  A CTA takes its (image, CTA
//      row) from an atomic ticket, in CTA-row-major order over the batch,
//      not from blockIdx.  Why no CTA waits on one that is not resident: a
//      CTA takes a ticket only once it runs, so tickets go out in the order
//      CTAs start; a warp waits only on the warp above it in its CTA, or,
//      for warp 0, on the last warp of the CTA with ticket t - B, which took
//      its ticket earlier and so is running or done.  By induction on the
//      ticket every waited-on warp is resident and makes progress, at any
//      number of resident CTAs.
//   4. Loads and stores off the chain.  Each lane copies its row's
//      residuals (aligned 16-byte vectors, or 4-byte words when `vec` is
//      off) kResAhead - 1 iterations ahead into a ring in shared memory
//      (cp.async), so no register waits on a load; it fetches the mode word
//      of the tile an iteration ahead.  It gathers its pixels into 16-byte
//      stores: lanes of even l fill an aligned vector in steps 0-3 of each
//      4, odd lanes in steps 2-3 and 0-1 of the next.  A width that is not
//      a multiple of 4, or a misaligned tensor, takes 4-byte accesses (the
//      loop is compiled for both, for the epilogue on and off, and for
//      tiles under 4 pixels wide).  No global load sits between one pixel
//      and the next, but for a row-above word found unmarked.
//   5. No divergent branch in the predictor.  Every candidate is computed
//      with byte-wise integer operations (avg2 is __vhaddu4, the add
//      __vadd4, Select compares __vsadu4 sums) and the two clamped
//      predictors on the even and odd channels as 16-bit lanes, added and
//      clipped by the DPX __viaddmin_s16x2_relu; avg2(TL, T) is the step
//      before's avg2(T, TR), carried.  The candidates go to the lane's
//      table in shared memory (three 16-byte stores and one 4-byte) and the
//      lane's mode picks one with one read: on the card the table beat a
//      chain of 14 predicated selects, whose integer issue cost more than
//      the table's store-and-read latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;      // rows a warp: lane l owns row kRows g + l
constexpr int kMaxWarps = 8;   // warps a CTA at most
constexpr int kSkew = 2;       // lane l runs kSkew columns behind lane l - 1
constexpr int kResSlots = 8;   // slots of a lane's residual ring
constexpr int kResAhead = 4;   // the vector copied at an iteration's end: kb + kResAhead
constexpr int kEdgeSlots = 4;  // slots of a warp's ring of row-above words
constexpr int kEdgeAhead = 2;  // the row-above words copied at an iteration's end: i + 2's
constexpr int kSmemReserve = 120 * 1024;  // dynamic shared memory a CTA holds: one CTA an SM
constexpr uint32_t kBlack = 0xff000000u;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kMark = 1ull << 32;  // a published edge word

static_assert(kSkew == 2, "the window and store phases assume a skew of 2");
static_assert((kResSlots & (kResSlots - 1)) == 0 && kResSlots >= kResAhead + 2,
              "the residual ring holds the window's two vectors and those in flight");
static_assert((kEdgeSlots & (kEdgeSlots - 1)) == 0 && kEdgeSlots > kEdgeAhead,
              "the edge ring holds this iteration's words and those in flight");
static_assert(kMaxWarps * kResSlots * 32 * 16 <= kSmemReserve, "the rings fit the reserve");

// ---------------------------------------------------------------- predictors

// floor((a + b) / 2) byte by byte (__vhaddu4); the low bits are masked
// before the shift, so the shift and the add can fuse (LEA.HI)
__device__ __forceinline__ uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

// (a + b) mod 256 byte by byte (__vadd4)
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

// Channels 0 and 2 (even) or 1 and 3 (odd) of a pixel as two 16-bit lanes;
// with `biased`, each lane less 256 (0xff in its high byte: the lane as a
// signed 16-bit number, with no borrow between lanes).
__device__ __forceinline__ uint32_t even_ch(uint32_t v, bool biased = false) {
  return __byte_perm(v, biased ? 0xffffffffu : 0u, 0x4240);
}
__device__ __forceinline__ uint32_t odd_ch(uint32_t v, bool biased = false) {
  return __byte_perm(v, biased ? 0xffffffffu : 0u, 0x4341);
}
// the pixel from its even and odd channel lanes (each in 0..255)
__device__ __forceinline__ uint32_t join_ch(uint32_t e, uint32_t o) {
  return __byte_perm(e, o, 0x6240);
}

// clip(l + t - tl) on two lanes: (l - 256) + (t - tl + 256), added and
// clipped to 0..255 lane by lane in one DPX instruction.  t - tl + 256 lies
// in 1..511, so no lane borrows from the next.
__device__ __forceinline__ uint32_t clamp_full2(uint32_t l_biased, uint32_t t, uint32_t tl) {
  return __viaddmin_s16x2_relu(l_biased, t + 0x01000100u - tl, 0x00ff00ffu);
}

// clip(a + d / 2), d = a - tl, the division truncating toward zero, on two
// lanes: a + trunc(d / 2) = floor((3a - tl + (d < 0)) / 2), and with
// k = 256 - tl, bit 8 of a + k is d >= 0 and 3a + k + (d < 0) lies in
// 1..1022; half of it, less 128, clipped to 0..255 lane by lane.  The
// multiply and adds can issue on the multiply-add pipe.
__device__ __forceinline__ uint32_t clamp_half2(uint32_t a, uint32_t tl) {
  const uint32_t k = 0x01000100u - tl;
  const uint32_t neg = ~((a + k) >> 8) & 0x00010001u;
  const uint32_t h = ((a * 3u + k + neg) >> 1) & 0x01ff01ffu;
  return __viaddmin_s16x2_relu(h, 0xff80ff80u, 0x00ff00ffu);
}

// Each lane's 14 candidates (and the constants black and 0, stored once)
// go to its own 16 words of shared memory, 4 of them a store, and its mode
// picks one with a single read: slot m - 1 for mode m in 1..13, kSlotBlack
// for mode 0, kSlotZero past 13.  Word of slot s: group s / 4 at 32 lanes
// x 4 words a group, so each group's store is one conflict-free STS.128.
constexpr int kSlotBlack = 13, kSlotZero = 14;

__device__ __forceinline__ int slot_word(int s) { return (s >> 2) * 128 + (s & 3); }

__device__ __forceinline__ int mode_word(uint32_t word) {
  const uint32_t m = (word >> 8) & 255u;
  return slot_word(m == 0 ? kSlotBlack : (m > 13 ? kSlotZero : (int)m - 1));
}

// A pixel above, with its even and odd channel lanes (split once, when it
// arrives as TR, and carried on as T and TL).
struct Above {
  uint32_t v, e, o;
};

__device__ __forceinline__ Above above_px(uint32_t v) { return {v, even_ch(v), odd_ch(v)}; }

// The candidates of every mode from L, T, TL and TR, into the lane's table;
// c8 = avg2(TL, T) is the step before's avg2(T, TR), which this returns.
__device__ __forceinline__ uint32_t candidates(uint4* tab, uint32_t l, const Above& T,
                                               const Above& TL, uint32_t tr, uint32_t c8) {
  const uint32_t t = T.v, tl = TL.v;
  const uint32_t a = avg2(l, t);
  const uint32_t c6 = avg2(l, tl), c9 = avg2(t, tr);
  const uint32_t tle = TL.e, tlo = TL.o;
  // Select: L when the T-TL gradient is the smaller (the format's crossed names)
  const uint32_t sel = __vsadu4(t, tl) < __vsadu4(l, tl) ? l : t;
  const uint32_t full = join_ch(clamp_full2(even_ch(l, true), T.e, tle),
                                clamp_full2(odd_ch(l, true), T.o, tlo));
  tab[0] = make_uint4(l, t, tr, tl);                                     // modes 1-4
  tab[32] = make_uint4(avg2(avg2(l, tr), t), c6, a, c8);                 // 5-8
  tab[64] = make_uint4(c9, avg2(c6, c9), sel, full);                     // 9-12
  reinterpret_cast<uint32_t*>(tab + 96)[0] =                              // 13
      join_ch(clamp_half2(even_ch(a), tle), clamp_half2(odd_ch(a), tlo));
  return c9;
}

// The add-green inverse: green added to red and blue.
__device__ __forceinline__ uint32_t add_green_px(uint32_t v) {
  return (((v & 0x00ff00ffu) + __byte_perm(v, 0u, 0x4141)) & 0x00ff00ffu) | (v & 0xff00ff00u);
}

// ------------------------------------------------------------------ memory

__device__ __forceinline__ unsigned long long ld_edge(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_edge(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// the edge word at p, once it is published
__device__ __forceinline__ unsigned long long wait_edge(const unsigned long long* p) {
  unsigned long long v = ld_edge(p);
  while (!(v >> 32)) v = ld_edge(p);
  return v;
}

// cp.async of 16 or 4 bytes from global to shared memory, zeros past `bytes`
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Aligned residual vector k of a row (x = 4k .. 4k + 3), zeros off the row,
// into its slot of the lane's ring.
template <bool kVec>
__device__ __forceinline__ void fetch_vec(uint4* ring, const uint32_t* row, const uint32_t* safe,
                                          int k, int w, bool act) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(ring + (k & (kResSlots - 1)) * 32);
  const int x = 4 * k;
  const bool ok = act && x >= 0 && x < w;
  if constexpr (kVec) {
    cp_async16(dst, ok ? row + x : safe, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; e++) {
      const bool oke = ok && x + e < w;
      cp_async4(dst + e, oke ? row + x + e : safe, oke ? 4 : 0);
    }
  }
}

// Words c .. c + 3 (c odd) of the row above into the warp's edge slot, two
// 16-byte copies (an edge row's odd words are 16-byte aligned); lane 0
// copies, the other lanes copy nothing into a dummy slot.
__device__ __forceinline__ void fetch_edge(ulonglong2* slot, ulonglong2* dummy,
                                           const unsigned long long* above, int c, int w,
                                           bool lane0) {
  if (!above) return;
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const bool ok = lane0 && c + 2 * h < w;
    cp_async16(ok ? slot + h : dummy, above + (ok ? c + 2 * h : 1), ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t& elem(uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// ------------------------------------------------------------------ kernel

// What a warp's lanes work on, from the kernel's set-up.
struct Rows {
  const uint32_t* res;    // a valid address (for zero-filled fetches)
  const uint32_t* rrow;   // the lane's row of residuals
  uint32_t* orow;         // and of pixels
  const uint32_t* mrow;   // the lane's (or, off the image, the last) row of tiles
  const unsigned long long* above;  // the row above the group (every lane), or null
  unsigned long long* below;        // lane 31: the group's last row, or null
  uint4* tab;             // the lane's candidate table
  uint4* ring;            // the lane's residual vectors
  ulonglong2* edge;       // the warp's ring of row-above words, 4 a slot
  ulonglong2* dummy;      // where the other lanes' edge copies go
  int lane, w, bits, tw, iters;
  bool act, odd, top;
};

// The warp's steps.  kVec: 16-byte residual and pixel accesses; kGreen: the
// add-green epilogue; kSmallTiles: bits < 2, a tile may start at any step.
template <bool kVec, bool kGreen, bool kSmallTiles>
__device__ __forceinline__ void run_rows(const Rows& r) {
  const int lane = r.lane, w = r.w, bits = r.bits;
  const int tmask = (1 << bits) - 1;
  // Residual vectors: slot k & (kResSlots - 1) of the ring holds aligned
  // vector k of the row; kb is that of x at the iteration's step 0
  // (x = 4 i - 2 lane: x = 4 kb, or 4 kb + 2 for an odd lane).  Row-above
  // words: slot i & (kEdgeSlots - 1) of the edge ring holds words 4 i + 1 ..
  // 4 i + 4, lane 0's TR at iteration i.  Iteration m's end commits the
  // copy of iteration m + kEdgeAhead's words, then that of vector
  // kb + kResAhead, as two cp.async groups; the prologue commits vectors
  // kb, kb + 1, then edge slot 0, vector kb + 2, edge slot 1, vector
  // kb + 3.  At an iteration's head all but the last 3 groups are complete:
  // its edge slot (kEdgeAhead = 2) and its window's vectors are in, and a
  // vector has had 3 iterations to arrive.
  const unsigned long long* above = r.above;
  const bool lane0 = lane == 0;
  Above tr = above_px(0u), t = tr, tl = tr;
  uint32_t left = 0u, first = 0u, made = 0u, c8 = 0u;
  if (above) {  // the group above has published the first copies' words and more
    wait_edge(above + min(4 * kEdgeAhead, w - 1));
    tr = above_px((uint32_t)wait_edge(above));
  }
  int kb = -((lane + 1) >> 1);
  fetch_vec<kVec>(r.ring, r.rrow, r.res, kb, w, r.act);
  fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + 1, w, r.act);
  asm volatile("cp.async.commit_group;" ::: "memory");
#pragma unroll
  for (int j = 0; j < kEdgeAhead; j++) {
    fetch_edge(r.edge + 2 * j, r.dummy, above, 4 * j + 1, w, lane0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + 2 + j, w, r.act);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  static_assert(kResAhead == kEdgeAhead + 2, "the prologue's vectors meet the loop's");
  // mode words: m0 (even lanes) and m2 (odd lanes) hold the word of the
  // tile of x + 4, fetched at steps 0 and 2 an iteration ahead of its use;
  // moff is the table word of the current tile's mode (row 0: L's, always)
  uint32_t m0 = __ldg(r.mrow), m2 = m0;
  int moff = slot_word(0);
  const int at0 = r.top ? slot_word(kSlotBlack) : slot_word(1);  // column 0: black or T
  const bool tiles = r.act && !r.top;  // a lane whose mode follows the tiles

  uint4 o = make_uint4(0u, 0u, 0u, 0u);  // the aligned output vector being gathered
  uint32_t nv = __shfl_up_sync(kFull, made, 1);  // the next step's pixel from the lane above
  for (int i = 0; i < r.iters; i++, kb++) {
    const int x0 = 4 * i - kSkew * lane;
    asm volatile("cp.async.wait_group 3;" ::: "memory");
    __syncwarp();  // lane 0's edge copies, seen by every lane
    // the row above: e[j] is word x + 1 + j at lane 0's step x (every lane
    // holds the same words); a word not yet published is read again
    unsigned long long e[4];
    {
      const ulonglong2 p0 = r.edge[2 * (i & (kEdgeSlots - 1))];
      const ulonglong2 p1 = r.edge[2 * (i & (kEdgeSlots - 1)) + 1];
      e[0] = p0.x, e[1] = p0.y, e[2] = p1.x, e[3] = p1.y;
    }
    if (above && !((e[0] & e[1] & e[2] & e[3]) >> 32)) {  // past the row, or not yet in
      const int c = 4 * i + 1;
#pragma unroll
      for (int j = 0; j < 4; j++)
        if (c + j < w && !(e[j] >> 32)) e[j] = wait_edge(above + c + j);
    }
    // the window x0 .. x0 + 3: vector kb, or the top half of kb and the
    // bottom half of kb + 1 for an odd lane
    const uint32_t* v0 = reinterpret_cast<const uint32_t*>(r.ring + (kb & (kResSlots - 1)) * 32);
    const uint32_t* v1 =
        reinterpret_cast<const uint32_t*>(r.ring + ((kb + 1) & (kResSlots - 1)) * 32);
    const uint2 r01 = *reinterpret_cast<const uint2*>(r.odd ? v0 + 2 : v0);
    const uint2 r23 = *reinterpret_cast<const uint2*>(r.odd ? v1 : v0 + 2);
    const uint32_t res4[4] = {r01.x, r01.y, r23.x, r23.y};
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int x = x0 + j;
      uint32_t v = nv;
      if (lane == 0) v = (uint32_t)e[j];
      tl = t;
      t = tr;
      tr = above_px(v);
      const bool in = r.act && (unsigned)x < (unsigned)w;
      if constexpr (kSmallTiles) {
        if (tiles && (unsigned)x < (unsigned)w && (x & tmask) == 0)
          moff = mode_word(__ldg(r.mrow + (x >> bits)));
      } else if (j == 0 || j == 2) {
        // a tile starts only at x = 0 mod 4: even lanes at step 0, odd at 2
        uint32_t& m = j == 0 ? m0 : m2;
        if (r.odd == (j == 2) && tiles && (unsigned)x < (unsigned)w && (x & tmask) == 0)
          moff = mode_word(m);
        m = __ldg(r.mrow + max(0, min((x + 4) >> bits, r.tw - 1)));
      }
      c8 = candidates(r.tab, left, t, tl, x + 1 < w ? tr.v : first, c8);
      const uint32_t px =
          add_bytes(res4[j], reinterpret_cast<const uint32_t*>(r.tab)[x == 0 ? at0 : moff]);
      if (x == 0) first = px;
      left = px;
      made = px;
      nv = __shfl_up_sync(kFull, made, 1);
      if (r.below && in) st_edge(r.below + x, kMark | px);
      const uint32_t ov = kGreen ? add_green_px(px) : px;
      if constexpr (kVec) {
        // even lanes fill element j of the output vector, odd lanes j ^ 2
        elem(o, j) = r.odd ? elem(o, j) : ov;
        elem(o, j ^ 2) = r.odd ? ov : elem(o, j ^ 2);
        if ((j == 1 && r.odd) || (j == 3 && !r.odd))
          if (r.act && kb >= 0 && 4 * kb < w) reinterpret_cast<uint4*>(r.orow)[kb] = o;
      } else {
        if (in) r.orow[x] = ov;
      }
    }
    const int n = i + kEdgeAhead;
    fetch_edge(r.edge + 2 * (n & (kEdgeSlots - 1)), r.dummy, above, 4 * n + 1, w, lane0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + kResAhead, w, r.act);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
vp8l_inverse_kernel(const uint32_t* __restrict__ res, const uint32_t* __restrict__ mode_img,
                    uint32_t* __restrict__ out, unsigned long long* __restrict__ edges,
                    unsigned int* __restrict__ ticket, int B, int h, int w, int bits, int tw,
                    int stride, int add_green, int vec) {
  __shared__ uint4 s_tab[kMaxWarps][4][32];          // each lane's candidates
  extern __shared__ uint4 s_ring[];                  // each lane's residual vectors
  __shared__ ulonglong2 s_edge[kMaxWarps][2 * kEdgeSlots + 1];  // each warp's edge ring, dummy
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int groups = (h + kRows - 1) / kRows;
  const int b = s_ticket % B;
  const int warp = threadIdx.x >> 5;
  const int g = (s_ticket / B) * (int)(blockDim.x >> 5) + warp;
  if (g >= groups) return;
  Rows r;
  r.lane = threadIdx.x & 31;
  const int y = g * kRows + r.lane;
  const int nrows = min(kRows, h - g * kRows);
  const size_t plane = (size_t)b * h * w;
  r.res = res;
  r.rrow = res + plane + (size_t)y * w;
  r.orow = out + plane + (size_t)y * w;
  r.mrow = mode_img + (size_t)(min(y, h - 1) >> bits) * tw;
  const size_t edge0 = (size_t)b * (groups - 1);
  r.above = g > 0 ? edges + (edge0 + g - 1) * stride : nullptr;
  r.below = r.lane == kRows - 1 && g + 1 < groups ? edges + (edge0 + g) * stride : nullptr;
  r.tab = &s_tab[warp][0][r.lane];
  r.ring = s_ring + warp * kResSlots * 32 + r.lane;
  r.edge = &s_edge[warp][0];
  r.dummy = &s_edge[warp][2 * kEdgeSlots];
  reinterpret_cast<uint32_t*>(r.tab + 96)[1] = kBlack;
  reinterpret_cast<uint32_t*>(r.tab + 96)[2] = 0u;
  r.w = w;
  r.bits = bits;
  r.tw = tw;
  r.iters = (w + kSkew * (nrows - 1) + 3) >> 2;
  r.act = y < h;
  r.odd = r.lane & 1;
  r.top = y == 0;
  const int form = (vec ? 4 : 0) | (add_green ? 2 : 0) | (bits < 2 ? 1 : 0);
  switch (form) {
    case 0: run_rows<false, false, false>(r); break;
    case 1: run_rows<false, false, true>(r); break;
    case 2: run_rows<false, true, false>(r); break;
    case 3: run_rows<false, true, true>(r); break;
    case 4: run_rows<true, false, false>(r); break;
    case 5: run_rows<true, false, true>(r); break;
    case 6: run_rows<true, true, false>(r); break;
    default: run_rows<true, true, true>(r); break;
  }
}

}  // namespace

// An edge row's words: w rounded up to even, so that its odd words are
// 16-byte aligned (the rows start at word 1 of the scratch).
static int edge_stride(int w) { return w + (w & 1); }

// 64-bit words of zeroed scratch a launch needs: the ticket, an edge row
// for each group boundary of each image, and a word a pair copy may read
// past the last row.
extern "C" long long vp8l_inverse_scratch_words(int B, int h, int w) {
  const long long groups = (h + kRows - 1) / kRows;
  return 2 + (long long)B * (groups - 1) * edge_stride(w);
}

// Inverts B residual images (B, h, w) sharing the mode image (th, tw),
// tw = ceil(w / 2^bits), into `out` (B, h, w), on `stream`; `add_green`
// non-zero applies the add-green inverse to each pixel as it is stored.
// `scratch` holds vp8l_inverse_scratch_words(B, h, w) zeroed words; `warps`
// is the warps a CTA (0: as few as fill the SMs).  Returns the CUDA error of the launch
// (0 = accepted).
extern "C" int vp8l_inverse_launch(const uint32_t* res, const uint32_t* mode_img, uint32_t* out,
                                   unsigned long long* scratch, int B, int h, int w, int bits,
                                   int add_green, int warps, void* stream) {
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  if (warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const int groups = (h + kRows - 1) / kRows;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one CTA an SM (the reserve), and as few warps a CTA as fill the SMs:
  // a warp's step is bound by its own issue and memory pipes
  cudaFuncSetAttribute(vp8l_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemReserve);
  if (warps <= 0) {
    const long long all = (long long)B * groups;
    warps = (int)min((long long)kMaxWarps, max(1LL, (all + sms - 1) / sms));
  }
  const long long ctas = (long long)B * ((groups + warps - 1) / warps);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tw = (w + (1 << bits) - 1) >> bits;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(res) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  vp8l_inverse_kernel<<<(unsigned)ctas, 32 * warps, kSmemReserve, (cudaStream_t)stream>>>(
      res, mode_img, out, scratch + 1, reinterpret_cast<unsigned int*>(scratch), B, h, w, bits,
      tw, edge_stride(w), add_green, vec);
  return (int)cudaGetLastError();
}
