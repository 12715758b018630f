// Interleaved multi-stream VP8 symbol decode (the batch-decode engine).
//
// The per-image boolean decoder is a strict serial dependency chain
// (~11 cycles/decision), and a branchy token parser adds a mispredict
// per decision — measured ~9 ns per decision on the single-stream
// engine (vp8_dec.cpp get_coeffs).  This engine removes both limits:
//
//   1. The token grammar (RFC 6386 §13.2-13.3) runs as a *branchless
//      DFA*: one table-driven transition per decoded bit — mask
//      arithmetic instead of conditional branches, a masked store
//      instead of a conditional coefficient store.
//   2. Many independent bitstreams are stepped in lockstep in ONE
//      thread.  On AVX-512 hardware, 16 streams live in the lanes of
//      ZMM registers and one vector step decodes one bit of each
//      (gathered probs/transitions, scattered coefficients, vplzcntd
//      renormalization).  A scalar round-robin fallback covers other
//      builds.
//   3. Multi-partition files (our own encoder emits up to 8 token
//      partitions, the format's parallel-decode hook — reference
//      pkg/vp8/vp8_dec.go:293 ParsePartitions) interleave *within* an
//      image: partition p owns rows y ≡ p (mod P); the one coupling —
//      the nz-context row above — is enforced with a per-row progress
//      gate (no atomics: one engine call is single-threaded; thread
//      parallelism comes from running engines on disjoint image sets).
//
// Mode parsing (partition 0) is a separate serial chain per image and
// runs as a sequential pre-pass.
//
// Outputs are bit-identical to wtpu_vp8_decode_symbols (vp8_dec.cpp),
// which itself is validated against the pure-Python RFC decoder and
// libwebp golden files.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512CD__) && defined(__AVX512BW__)
#define WTPU_AVX512 1
#include <immintrin.h>
#endif

#include "vp8_tables.h"

namespace {

// ----------------------------------------------------------------------
// RFC-convention boolean decoder for the sequential mode pre-pass.
// ----------------------------------------------------------------------
struct BoolDec {
  const uint8_t* data;
  uint64_t size;
  uint64_t pos;
  uint32_t value;
  uint32_t range;
  int bit_count;

  void init(const uint8_t* d, uint64_t n, uint64_t p, uint32_t v,
            uint32_t r, int bc) {
    data = d; size = n; pos = p; value = v; range = r; bit_count = bc;
  }
  inline uint32_t next_byte() {
    uint32_t b = pos < size ? data[pos] : 0;
    pos++;
    return b;
  }
  inline int get(int prob) {
    uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    uint32_t big = split << 8;
    int ret;
    if (value >= big) {
      ret = 1; range -= split; value -= big;
    } else {
      ret = 0; range = split;
    }
    while (range < 128) {
      value <<= 1; range <<= 1;
      if (++bit_count == 8) { bit_count = 0; value |= next_byte(); }
    }
    return ret;
  }
  inline bool exhausted() const { return pos > size + 4; }
};

// ----------------------------------------------------------------------
// Token-grammar DFA.
// States follow get_coeffs (vp8_dec.cpp) / RFC 6386 token tree.
// ----------------------------------------------------------------------
enum : uint32_t {
  S0 = 0,   // EOB check            p[0]
  S1,       // zero check           p[1]
  S2,       // one check            p[2]
  L3,       // large: low/high      p[3]
  L4,       //   low: 2 / 3+bit     p[4]
  L5,       //     v = 3 + bit      p[5]
  L6,       //   high: cat12 / catN p[6]
  L7,       //     cat1/cat2        p[7]
  C159,     //     v = 5 + bit      const 159
  C165,     //     v = 7 + 2*bit    const 165
  C145,     //     v += bit         const 145
  L8,       //   catN bit1          p[8]
  L9A,      //   catN bit0 (b1=0)   p[9]
  L9B,      //   catN bit0 (b1=1)   p[10]
  CAT_BASE, // 23 cat-extra-bit states (3+4+5+11)
  SIGN = CAT_BASE + 23,
  PARK,     // idle-lane trap state: loops forever, no side effects
  NSTATES,
};

// Expanded probability rows: one 40-byte row per (type, band, ctx)
// holding the probability the DFA needs in EVERY state — grammar
// states map into the 11 stream probs, constant states carry their
// constants.  One gather replaces (cprob load + poff load + pb load +
// select) and, crucially, the next step's prob can be prefetched as
// soon as the next state is known.
constexpr uint32_t PV_STRIDE = 40;           // NSTATES=39 rounded up

struct Tables {
  uint32_t ent[NSTATES * 2];   // ns(6) adv(1) eob(1) va(8..15) vm(16..17) vb(18..19)
  uint8_t poff[NSTATES];       // index into the 11-prob row (grammar states)
  uint8_t cprob[NSTATES];      // nonzero => constant probability
  uint32_t bandoff[17 * 3];    // (kBands[n]*3 + ctx) * PV_STRIDE
  uint32_t zz32[32];           // kZigzag widened (padded)
};

static Tables build_tables() {
  Tables t{};
  auto ent = [](uint32_t ns, uint32_t adv, uint32_t eob, uint32_t va,
                uint32_t vm, uint32_t vb) -> uint32_t {
    return ns | (adv << 6) | (eob << 7) | (va << 8) | (vm << 16) | (vb << 18);
  };
  t.ent[S0 * 2 + 0] = ent(S0, 0, 1, 0, 0, 0);     // EOB
  t.ent[S0 * 2 + 1] = ent(S1, 0, 0, 0, 0, 0);
  t.ent[S1 * 2 + 0] = ent(S1, 1, 0, 0, 0, 0);     // zero: n++
  t.ent[S1 * 2 + 1] = ent(S2, 0, 0, 0, 0, 0);
  t.ent[S2 * 2 + 0] = ent(SIGN, 0, 0, 1, 0, 0);   // v = 1
  t.ent[S2 * 2 + 1] = ent(L3, 0, 0, 0, 0, 0);
  t.ent[L3 * 2 + 0] = ent(L4, 0, 0, 0, 0, 0);
  t.ent[L3 * 2 + 1] = ent(L6, 0, 0, 0, 0, 0);
  t.ent[L4 * 2 + 0] = ent(SIGN, 0, 0, 2, 0, 0);   // v = 2
  t.ent[L4 * 2 + 1] = ent(L5, 0, 0, 0, 0, 0);
  t.ent[L5 * 2 + 0] = ent(SIGN, 0, 0, 3, 0, 1);   // v = 3 + bit
  t.ent[L5 * 2 + 1] = ent(SIGN, 0, 0, 3, 0, 1);
  t.ent[L6 * 2 + 0] = ent(L7, 0, 0, 0, 0, 0);
  t.ent[L6 * 2 + 1] = ent(L8, 0, 0, 0, 0, 0);
  t.ent[L7 * 2 + 0] = ent(C159, 0, 0, 0, 0, 0);
  t.ent[L7 * 2 + 1] = ent(C165, 0, 0, 0, 0, 0);
  t.ent[C159 * 2 + 0] = ent(SIGN, 0, 0, 5, 0, 1);   // v = 5 + bit
  t.ent[C159 * 2 + 1] = ent(SIGN, 0, 0, 5, 0, 1);
  t.ent[C165 * 2 + 0] = ent(C145, 0, 0, 7, 0, 2);   // v = 7 + 2*bit
  t.ent[C165 * 2 + 1] = ent(C145, 0, 0, 7, 0, 2);
  t.ent[C145 * 2 + 0] = ent(SIGN, 0, 0, 0, 1, 1);   // v += bit
  t.ent[C145 * 2 + 1] = ent(SIGN, 0, 0, 0, 1, 1);
  t.ent[L8 * 2 + 0] = ent(L9A, 0, 0, 0, 0, 0);
  t.ent[L8 * 2 + 1] = ent(L9B, 0, 0, 0, 0, 0);
  // cat states: cat c consumes kCatBits[c] extra bits (v = 2v + bit),
  // the last one also adds the category base 3 + (8 << c).
  uint32_t cat_start[4];
  {
    uint32_t s = CAT_BASE;
    for (int c = 0; c < 4; c++) { cat_start[c] = s; s += kCatBits[c]; }
  }
  t.ent[L9A * 2 + 0] = ent(cat_start[0], 0, 0, 0, 0, 0);  // v = 0
  t.ent[L9A * 2 + 1] = ent(cat_start[1], 0, 0, 0, 0, 0);
  t.ent[L9B * 2 + 0] = ent(cat_start[2], 0, 0, 0, 0, 0);
  t.ent[L9B * 2 + 1] = ent(cat_start[3], 0, 0, 0, 0, 0);
  for (int c = 0; c < 4; c++) {
    for (int i = 0; i < kCatBits[c]; i++) {
      uint32_t s = cat_start[c] + i;
      bool last = i == kCatBits[c] - 1;
      uint32_t va = last ? (uint32_t)(3 + (8 << c)) : 0;
      uint32_t ns = last ? SIGN : s + 1;
      t.ent[s * 2 + 0] = ent(ns, 0, 0, va, 2, 1);   // v = 2v + bit (+base)
      t.ent[s * 2 + 1] = ent(ns, 0, 0, va, 2, 1);
      t.cprob[s] = kCatProbas[c][i];
    }
  }
  t.ent[SIGN * 2 + 0] = ent(S0, 1, 0, 0, 0, 0);   // store, n++
  t.ent[SIGN * 2 + 1] = ent(S0, 1, 0, 0, 0, 0);
  t.ent[PARK * 2 + 0] = ent(PARK, 0, 0, 0, 0, 0);
  t.ent[PARK * 2 + 1] = ent(PARK, 0, 0, 0, 0, 0);

  t.poff[S0] = 0; t.poff[S1] = 1; t.poff[S2] = 2; t.poff[L3] = 3;
  t.poff[L4] = 4; t.poff[L5] = 5; t.poff[L6] = 6; t.poff[L7] = 7;
  t.poff[L8] = 8; t.poff[L9A] = 9; t.poff[L9B] = 10;
  t.cprob[C159] = 159; t.cprob[C165] = 165; t.cprob[C145] = 145;
  t.cprob[SIGN] = 128; t.cprob[PARK] = 128;
  for (int n = 0; n <= 16; n++)
    for (int c = 0; c < 3; c++)
      t.bandoff[n * 3 + c] = (kBands[n] * 3u + c) * PV_STRIDE;
  for (int i = 0; i < 16; i++) t.zz32[i] = kZigzag[i];
  return t;
}

static const Tables T = build_tables();

// Fill one image's expanded prob rows from its [4][8][3][11] table.
static void expand_probs(const uint8_t* probs, uint8_t* pv) {
  for (int ty = 0; ty < 4; ty++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++) {
        const uint8_t* row = probs + ((ty * 8 + b) * 3 + c) * 11;
        uint8_t* out = pv + ((ty * 8 + b) * 3 + c) * PV_STRIDE;
        for (uint32_t s = 0; s < NSTATES; s++)
          out[s] = T.cprob[s] ? T.cprob[s] : row[T.poff[s]];
      }
}

// ----------------------------------------------------------------------
// Per-image shared data and per-stream (lane) bookkeeping.
// ----------------------------------------------------------------------
struct ImageCtx {
  int mb_w, mb_h, num_parts;
  const int32_t* quants;        // [4][6]
  int use_skip;
  int16_t* coeffs_out;          // [n][24][16]
  uint8_t* modes_out;           // [n][21] (pre-pass modes; skip/dither updated)
  uint32_t pv_off;              // this image's base in the prob arena
  std::vector<uint32_t> above_nz;
  std::vector<uint8_t> above_dc;
  std::vector<int32_t> prog;    // MBs completed per row (partition gate)
  int error = 0;
};

enum Phase : uint8_t { PH_Y2, PH_LUMA, PH_U, PH_V };

// Hot DFA/bool-decoder state, stored as structure-of-arrays so the
// vector engine can load each field as one ZMM register (lane k =
// stream k).  The scalar fallback walks the same arrays.
// 32 lanes = two 16-lane vector groups stepped alternately: one
// group's serial dependency chain (prob gather -> state -> next
// gather) overlaps the other's in the out-of-order core.
constexpr int NLANES = 32;

struct Hot {
  uint32_t value[NLANES];
  uint32_t range[NLANES];
  int32_t bits[NLANES];
  uint32_t buf_off[NLANES];  // byte offset into the shared partition arena
  uint32_t state[NLANES];
  uint32_t n[NLANES];
  uint32_t v[NLANES];
  uint32_t nctx[NLANES];
  uint32_t pv_off[NLANES];   // current prob row (byte offset in prob arena)
  uint32_t pv_base[NLANES];  // current block type's band-0/ctx-0 row base
  int32_t dq0[NLANES];
  int32_t dq1[NLANES];
  uint32_t prob[NLANES];     // preloaded probability for the next step
};

// Cold per-stream bookkeeping (slow path only).
struct Lane {
  ImageCtx* img = nullptr;
  int part = 0, mb_x = 0, mb_y = 0;
  Phase phase = PH_LUMA;
  uint32_t bi = 0, first = 0;
  uint32_t tnz = 0, lnz = 0, lbit = 0;
  uint32_t out_t = 0, out_l = 0, any_nz = 0, uv_ac = 0;
  uint32_t ctx_left_nz = 0;
  uint8_t ctx_left_dc = 0;
  uint32_t buf_start = 0;       // arena offset of this partition
  uint64_t buf_size = 0;        // real (unpadded) partition size
  int blocked = 0, done = 0;
  // Saved boolean-decoder state while the lane is parked: a parked
  // lane keeps stepping in the vector engine (PARK state has no side
  // effects on outputs) but its value/range/bits churn, so a blocked
  // stream must stash and restore them.
  uint32_t s_value = 0, s_range = 254, s_buf_off = 0;
  int32_t s_bits = -8;
};

struct Engine {
  Hot hot;
  Lane lanes[NLANES];
  alignas(64) int32_t staging[NLANES * 16];  // one 4x4 i32 block per lane
  const uint8_t* arena;         // all partitions, padded
  const uint8_t* pv_arena;      // expanded prob rows, all images
  std::vector<Lane> pending;    // streams waiting for a free lane
  uint32_t active = 0;          // lane occupancy mask
  int n_blocked = 0;            // gate-blocked parked lanes
  uint32_t bool_dirty = 0;      // lanes whose value/range/bits/buf changed
};

static void iwht4x4_i32(const int32_t* in, int32_t* out) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) {
    int32_t a0 = in[0 + i] + in[12 + i];
    int32_t a1 = in[4 + i] + in[8 + i];
    int32_t a2 = in[4 + i] - in[8 + i];
    int32_t a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[4 + i] = a3 + a2;
    tmp[8 + i] = a0 - a1;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    int32_t dc = tmp[0 + i * 4] + 3;
    int32_t a0 = dc + tmp[3 + i * 4];
    int32_t a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    int32_t a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    int32_t a3 = dc - tmp[3 + i * 4];
    out[i * 4 + 0] = (a0 + a1) >> 3;
    out[i * 4 + 1] = (a3 + a2) >> 3;
    out[i * 4 + 2] = (a0 - a1) >> 3;
    out[i * 4 + 3] = (a3 - a2) >> 3;
  }
}

// Arm lane k's DFA on one block.  type_row = arena offset of the block
// type's (band 0, ctx 0) row; ctx0 picks the initial band row.
static inline void arm_block(Engine& eng, int k, uint32_t type_row,
                             uint32_t first, uint32_t ctx0,
                             int32_t dq_dc, int32_t dq_ac) {
  Hot& h = eng.hot;
  h.state[k] = S0;
  h.n[k] = first;
  h.v[k] = 0;
  h.nctx[k] = 0;
  h.pv_base[k] = type_row;
  h.pv_off[k] = type_row + T.bandoff[first * 3 + ctx0];
  h.dq0[k] = dq_dc;
  h.dq1[k] = dq_ac;
  h.prob[k] = eng.pv_arena[h.pv_off[k] + S0];
  std::memset(eng.staging + k * 16, 0, 16 * sizeof(int32_t));
}

static bool start_mb(Engine& eng, int k);

// The lane's current block finished (nz = hot.n[k]).  Advance the MB
// state machine and arm the next block.  Returns false when the lane
// has no more work (stream finished or gate-blocked).
static bool block_done(Engine& eng, int k) {
  Lane& ln = eng.lanes[k];
  ImageCtx& im = *ln.img;
  Hot& h = eng.hot;
  // Exhaustion check every block: one block consumes < 512 bytes even
  // in the worst case, so with the 4 KB inter-partition guard the hot
  // loop's blind reads stay inside the arena and a truncated/corrupt
  // stream is flagged before leaving it.
  if ((uint64_t)(h.buf_off[k] - ln.buf_start) > ln.buf_size + 8) {
    im.error = 1;
    ln.done = 1;
    return false;
  }
  const uint32_t nz = h.n[k];
  const int mbi = ln.mb_y * im.mb_w + ln.mb_x;
  int16_t* mb_coeffs = im.coeffs_out + (size_t)mbi * 24 * 16;
  uint8_t* mb_modes = im.modes_out + (size_t)mbi * 21;
  const int32_t* q = im.quants + mb_modes[2] * 6;
  const int32_t* stg = eng.staging + k * 16;
  const uint32_t tb = im.pv_off;   // image's type-0 row base

  switch (ln.phase) {
    case PH_Y2: {
      im.above_dc[ln.mb_x] = ln.ctx_left_dc = (nz > 0);
      ln.any_nz |= (nz > 0);
      int32_t dcs[16];
      if (nz > 1) {
        iwht4x4_i32(stg, dcs);
      } else {
        int32_t dc0 = (stg[0] + 3) >> 3;
        for (int i = 0; i < 16; i++) dcs[i] = dc0;
      }
      for (int i = 0; i < 16; i++) mb_coeffs[i * 16] = (int16_t)dcs[i];
      ln.phase = PH_LUMA;
      ln.bi = 0;
      ln.first = 1;
      ln.tnz = im.above_nz[ln.mb_x] & 0x0f;
      ln.lnz = ln.ctx_left_nz & 0x0f;
      ln.lbit = ln.lnz & 1;
      arm_block(eng, k, tb + 0 * 8 * 3 * PV_STRIDE, 1,
                ln.lbit + (ln.tnz & 1), q[0], q[1]);
      return true;
    }
    case PH_LUMA: {
      // Staging already holds RASTER positions (the scatter indexes by
      // kZigzag), so narrowing is a straight copy; position 0 of i16
      // luma blocks holds the WHT DC and must survive (first==1 blocks
      // never stage position 0, which stays 0 from the arm memset).
      int16_t* bc = mb_coeffs + ln.bi * 16;
      int16_t dc0 = bc[0];
      for (int i = 0; i < 16; i++) bc[i] = (int16_t)stg[i];
      if (ln.first) bc[0] = dc0;
      uint32_t l = nz > ln.first;
      ln.tnz = (ln.tnz >> 1) | (l << 7);
      bool has = nz > ln.first || bc[0] != 0;
      ln.any_nz |= (uint32_t)has;
      if ((ln.bi & 3) == 3) {
        ln.tnz >>= 4;
        ln.lnz = (ln.lnz >> 1) | (l << 7);
        ln.lbit = ln.lnz & 1;
      } else {
        ln.lbit = l;
      }
      ln.bi++;
      if (ln.bi < 16) {
        // same block type/first; only band row + output move
        arm_block(eng, k, h.pv_base[k], ln.first,
                  ln.lbit + (ln.tnz & 1), q[0], q[1]);
        return true;
      }
      ln.out_t = ln.tnz;
      ln.out_l = ln.lnz >> 4;
      ln.phase = PH_U;
      ln.bi = 16;
      ln.first = 0;
      ln.tnz = (im.above_nz[ln.mb_x] >> 4) & 0xff;
      ln.lnz = (ln.ctx_left_nz >> 4) & 0xff;
      ln.lbit = ln.lnz & 1;
      arm_block(eng, k, tb + 2 * 8 * 3 * PV_STRIDE, 0,
                ln.lbit + (ln.tnz & 1), q[4], q[5]);
      return true;
    }
    case PH_U:
    case PH_V: {
      int16_t* bc = mb_coeffs + ln.bi * 16;
      for (int i = 0; i < 16; i++) bc[i] = (int16_t)stg[i];
      uint32_t l = nz > 0;
      ln.any_nz |= l;
      ln.uv_ac |= (uint32_t)(nz > 1);
      ln.tnz = (ln.tnz >> 1) | (l << 3);
      uint32_t local = ln.bi - (ln.phase == PH_U ? 16 : 20);
      if ((local & 1) == 1) {   // xx == 1: chroma row done
        ln.tnz >>= 2;
        ln.lnz = (ln.lnz >> 1) | (l << 5);
        ln.lbit = ln.lnz & 1;
      } else {
        ln.lbit = l;
      }
      ln.bi++;
      uint32_t ch = ln.phase == PH_U ? 0 : 2;
      if (ln.bi < (ln.phase == PH_U ? 20u : 24u)) {
        arm_block(eng, k, h.pv_base[k], 0, ln.lbit + (ln.tnz & 1),
                  q[4], q[5]);
        return true;
      }
      ln.out_t |= ((ln.tnz << 4) << ch);
      ln.out_l |= ((ln.lnz & 0xf0) << ch);
      if (ln.phase == PH_U) {
        ln.phase = PH_V;
        ln.bi = 20;
        ln.tnz = (im.above_nz[ln.mb_x] >> 6) & 0xff;
        ln.lnz = (ln.ctx_left_nz >> 6) & 0xff;
        ln.lbit = ln.lnz & 1;
        arm_block(eng, k, h.pv_base[k], 0, ln.lbit + (ln.tnz & 1),
                  q[4], q[5]);
        return true;
      }
      // ---- MB complete ----
      im.above_nz[ln.mb_x] = ln.out_t;
      ln.ctx_left_nz = ln.out_l;
      mb_modes[3] = !ln.any_nz;          // "empty" skip flag
      mb_modes[4] = ln.uv_ac ? 0 : 1;    // dither-eligible
      im.prog[ln.mb_y] = ln.mb_x + 1;
      ln.mb_x++;
      return start_mb(eng, k);
    }
  }
  return false;
}

// Position lane k at its next coded MB (handling skip MBs, row
// advance, and the row-above progress gate); arms the first block.
// Returns false if the stream is finished or blocked.
static bool start_mb(Engine& eng, int k) {
  Lane& ln = eng.lanes[k];
  ImageCtx& im = *ln.img;
  for (;;) {
    if (ln.mb_x >= im.mb_w) {
      ln.mb_y += im.num_parts;   // next row owned by this partition
      if (ln.mb_y >= im.mb_h) { ln.done = 1; return false; }
      ln.mb_x = 0;
      ln.ctx_left_nz = 0;
      ln.ctx_left_dc = 0;
    }
    // gate: the row above must have finished column mb_x
    if (ln.mb_y > 0 && im.prog[ln.mb_y - 1] <= ln.mb_x) {
      ln.blocked = 1;
      return false;
    }
    ln.blocked = 0;
    const int mbi = ln.mb_y * im.mb_w + ln.mb_x;
    const uint8_t* m = im.modes_out + (size_t)mbi * 21;
    uint8_t* mo = im.modes_out + (size_t)mbi * 21;
    const int is_i4 = m[0];
    const int skip = im.use_skip ? m[3] : 0;
    if (skip) {
      im.above_nz[ln.mb_x] = 0;
      ln.ctx_left_nz = 0;
      if (!is_i4) { im.above_dc[ln.mb_x] = 0; ln.ctx_left_dc = 0; }
      mo[3] = 1;
      mo[4] = 0;   // explicitly skipped MBs are never dithered
      // coded MBs overwrite all 24x16 coefficients from the zeroed
      // staging blocks, so only skip MBs need explicit zeros (the big
      // up-front whole-image memset is gone)
      std::memset(im.coeffs_out + (size_t)mbi * 24 * 16, 0,
                  24 * 16 * sizeof(int16_t));
      im.prog[ln.mb_y] = ln.mb_x + 1;
      ln.mb_x++;
      continue;
    }
    ln.any_nz = 0;
    ln.uv_ac = 0;
    const int32_t* q = im.quants + m[2] * 6;
    const uint32_t tb = im.pv_off;
    if (!is_i4) {
      ln.phase = PH_Y2;
      ln.first = 0;
      uint32_t ctx = im.above_dc[ln.mb_x] + ln.ctx_left_dc;
      arm_block(eng, k, tb + 1 * 8 * 3 * PV_STRIDE, 0, ctx, q[2], q[3]);
    } else {
      ln.phase = PH_LUMA;
      ln.bi = 0;
      ln.first = 0;
      ln.tnz = im.above_nz[ln.mb_x] & 0x0f;
      ln.lnz = ln.ctx_left_nz & 0x0f;
      ln.lbit = ln.lnz & 1;
      arm_block(eng, k, tb + 3 * 8 * 3 * PV_STRIDE, 0,
                ln.lbit + (ln.tnz & 1), q[0], q[1]);
    }
    return true;
  }
}

// Park lane k: PARK state never advances, stores, or signals done, and
// its refill is suppressed (the vector step gathers only for active
// lanes; the huge bits value keeps the scalar semantics), so the vector
// step can keep running it without side effects or out-of-bounds indices.
// The boolean-decoder state is stashed in the Lane first (the parked
// lane's arithmetic keeps churning value/range/bits harmlessly).
static inline void park_lane(Engine& eng, int k) {
  Hot& h = eng.hot;
  Lane& ln = eng.lanes[k];
  eng.bool_dirty |= 1u << k;
  ln.s_value = h.value[k];
  ln.s_range = h.range[k];
  ln.s_bits = h.bits[k];
  ln.s_buf_off = h.buf_off[k];
  h.state[k] = PARK;
  h.n[k] = 0;
  h.bits[k] = 1 << 20;
  h.pv_off[k] = 0;
  h.pv_base[k] = 0;
  h.prob[k] = 128;
  eng.active &= ~(1u << k);
}

static inline void unpark_lane(Engine& eng, int k) {
  eng.bool_dirty |= 1u << k;
  Hot& h = eng.hot;
  const Lane& ln = eng.lanes[k];
  h.value[k] = ln.s_value;
  h.range[k] = ln.s_range;
  h.bits[k] = ln.s_bits;
  h.buf_off[k] = ln.s_buf_off;
  eng.active |= 1u << k;
}

// Install a pending stream's bookkeeping into lane k and initialize
// its boolean decoder.  Returns false if it immediately blocked/ended.
static bool install_stream(Engine& eng, int k, const Lane& src) {
  eng.lanes[k] = src;
  Hot& h = eng.hot;
  h.value[k] = 0;
  h.range[k] = 254;    // stored as real_range - 1
  h.bits[k] = -8;
  h.buf_off[k] = src.buf_start;
  eng.bool_dirty |= 1u << k;
  if (start_mb(eng, k)) {
    eng.active |= 1u << k;
    return true;
  }
  park_lane(eng, k);   // stashes the fresh bool state for a later unpark
  return false;
}

// One scalar DFA step for lane k (fallback engine; also documents the
// exact semantics the vector step implements 16-wide).
static inline uint32_t step_scalar(Engine& eng, int k) {
  Hot& h = eng.hot;
  if (h.bits[k] < 0) {
    h.value[k] = (h.value[k] << 8) | eng.arena[h.buf_off[k]];
    h.buf_off[k]++;
    h.bits[k] += 8;
  }
  const uint32_t sidx = h.state[k];
  const uint32_t prob = h.prob[k];
  const int pos = h.bits[k];
  const uint32_t split = (h.range[k] * prob) >> 8;
  const uint32_t vv = (h.value[k] >> pos) & 0xff;
  const uint32_t bit = vv > split;
  const uint32_t mask = 0 - bit;
  const uint32_t r_sel = (split + 1) + (mask & (h.range[k] - 2 * split - 1));
  h.value[k] -= ((split + 1) & mask) << pos;
  const int shift = __builtin_clz(r_sel) - 24;
  h.bits[k] = pos - shift;
  h.range[k] = (r_sel << shift) - 1;
  const uint32_t e = T.ent[sidx * 2 + bit];
  const uint32_t ns = e & 63;
  const uint32_t adv = (e >> 6) & 1;
  const uint32_t eob = (e >> 7) & 1;
  const uint32_t vold = h.v[k];
  h.v[k] = vold * ((e >> 16) & 3) + bit * ((e >> 18) & 3) + ((e >> 8) & 255);
  const uint32_t is_s2 = 0 - (uint32_t)(sidx == S2);
  h.nctx[k] = ((1 + bit) & is_s2) | (h.nctx[k] & ~is_s2);
  const uint32_t n = h.n[k];
  const int32_t sv = (int32_t)((vold ^ (0 - bit)) + bit);
  const uint32_t nz_n = 0 - (uint32_t)(n != 0);
  const int32_t dq = (h.dq1[k] & nz_n) | (h.dq0[k] & ~nz_n);
  const uint32_t smask = 0 - (uint32_t)(sidx == SIGN);
  eng.staging[k * 16 + T.zz32[n & 15]] = (sv * dq) & (int32_t)smask;
  const uint32_t nn = n + adv;
  h.n[k] = nn;
  const uint32_t csel = h.nctx[k] & smask;
  const uint32_t pvn = h.pv_base[k] + T.bandoff[nn * 3 + csel];
  const uint32_t amask = 0 - adv;
  h.pv_off[k] = (pvn & amask) | (h.pv_off[k] & ~amask);
  h.state[k] = ns;
  h.prob[k] = eng.pv_arena[h.pv_off[k] + ns];
  return eob | (adv & (nn >> 4));
}

// Handle a lane whose block finished: run bookkeeping; if the lane
// goes idle, try to refill it from pending streams (or other blocked
// lanes' gates may have opened).
static void lane_done(Engine& eng, int k) {
  if (block_done(eng, k)) return;
  // lane idle: stream finished or blocked
  if (eng.lanes[k].blocked) {
    park_lane(eng, k);
    eng.n_blocked++;
    return;   // retried by the outer loop
  }
  // stream finished: try to install a pending stream
  park_lane(eng, k);
  while (!eng.pending.empty()) {
    Lane src = eng.pending.back();
    eng.pending.pop_back();
    if (install_stream(eng, k, src)) return;
    if (eng.lanes[k].blocked) {
      eng.n_blocked++;
      return;   // keep it in the lane, parked
    }
  }
}

// Retry gate-blocked lanes (at most num_parts-1 per image; callers
// skip the scan entirely via eng.n_blocked for single-partition work).
static void retry_blocked(Engine& eng) {
  if (!eng.n_blocked) return;
  for (int k = 0; k < NLANES; k++) {
    if (eng.lanes[k].img && eng.lanes[k].blocked && !eng.lanes[k].done &&
        !(eng.active & (1u << k))) {
      if (start_mb(eng, k)) {
        eng.lanes[k].blocked = 0;
        eng.n_blocked--;
        unpark_lane(eng, k);
      }
    }
  }
}

#ifdef WTPU_AVX512

// The DFA transition table split for register-resident lookups: the
// 39-state table fits two ZMMs of u16 per (bit, half), so a
// vpermi2w pair replaces the per-step gather.
struct EntTables {
  __m512i lo[2][2];   // [bit][half-selector regs]
  __m512i hi[2][2];
};

static EntTables build_ent_tables() {
  alignas(64) uint16_t lo[2][64] = {};
  alignas(64) uint16_t hi[2][64] = {};
  for (uint32_t s = 0; s < NSTATES; s++)
    for (int b = 0; b < 2; b++) {
      lo[b][s] = (uint16_t)(T.ent[s * 2 + b] & 0xFFFF);
      hi[b][s] = (uint16_t)(T.ent[s * 2 + b] >> 16);
    }
  EntTables t;
  for (int b = 0; b < 2; b++) {
    t.lo[b][0] = _mm512_load_si512(lo[b]);
    t.lo[b][1] = _mm512_load_si512(lo[b] + 32);
    t.hi[b][0] = _mm512_load_si512(hi[b]);
    t.hi[b][1] = _mm512_load_si512(hi[b] + 32);
  }
  return t;
}

static const EntTables ET = build_ent_tables();

// 16-lane vector step: decodes one boolean decision of every active
// stream per iteration.  Returns the done mask (blocks finished).
// All semantics mirror step_scalar exactly.
static inline uint16_t step_avx512(Engine& eng, int32_t* staging_base,
                                   __m512i& value,
                                   __m512i& range, __m512i& bits,
                                   __m512i& buf_off, __m512i& state,
                                   __m512i& n, __m512i& v, __m512i& nctx,
                                   __m512i& pv_off, const __m512i pv_base,
                                   const __m512i dq0, const __m512i dq1,
                                   __m512i& prob, uint16_t active) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i c255 = _mm512_set1_epi32(0xff);
  // refill: pull one byte where an active lane's bits < 0 (masked
  // gather).  A parked lane's bits start at 2^20 but keep falling as it
  // churns, so without the active mask a lane parked for more than ~2^20
  // steps (one long partition decoded alone) would walk its stale
  // buf_off past the end of the arena.
  const __mmask16 need = _mm512_mask_cmplt_epi32_mask(active, bits, zero);
  const __m512i byt = _mm512_and_epi32(
      _mm512_mask_i32gather_epi32(zero, need, buf_off,
                                  (const int*)eng.arena, 1),
      c255);
  value = _mm512_mask_or_epi32(value, need,
                               _mm512_slli_epi32(value, 8), byt);
  bits = _mm512_mask_add_epi32(bits, need, bits, _mm512_set1_epi32(8));
  buf_off = _mm512_mask_add_epi32(buf_off, need, buf_off, one);
  // boolean decode
  const __m512i split = _mm512_srli_epi32(_mm512_mullo_epi32(range, prob), 8);
  const __m512i vv = _mm512_and_epi32(_mm512_srlv_epi32(value, bits), c255);
  const __mmask16 bitk = _mm512_cmpgt_epi32_mask(vv, split);
  const __m512i split1 = _mm512_add_epi32(split, one);
  const __m512i r_sel = _mm512_mask_sub_epi32(split1, bitk, range, split);
  value = _mm512_mask_sub_epi32(value, bitk, value,
                                _mm512_sllv_epi32(split1, bits));
  const __m512i shift = _mm512_sub_epi32(_mm512_lzcnt_epi32(r_sel),
                                         _mm512_set1_epi32(24));
  bits = _mm512_sub_epi32(bits, shift);
  range = _mm512_sub_epi32(_mm512_sllv_epi32(r_sel, shift), one);
  // DFA transition: per-bit table halves permuted from registers
  // (vpermi2w over 64 u16 entries; even u16 lanes carry the result)
  const __m512i bitv = _mm512_maskz_mov_epi32(bitk, one);
  const __m512i c16 = _mm512_set1_epi32(0xFFFF);
  const __m512i e_lo = _mm512_and_epi32(
      _mm512_mask_mov_epi32(
          _mm512_permutex2var_epi16(ET.lo[0][0], state, ET.lo[0][1]), bitk,
          _mm512_permutex2var_epi16(ET.lo[1][0], state, ET.lo[1][1])),
      c16);
  const __m512i e_hi = _mm512_and_epi32(
      _mm512_mask_mov_epi32(
          _mm512_permutex2var_epi16(ET.hi[0][0], state, ET.hi[0][1]), bitk,
          _mm512_permutex2var_epi16(ET.hi[1][0], state, ET.hi[1][1])),
      c16);
  const __m512i e = _mm512_or_epi32(e_lo, _mm512_slli_epi32(e_hi, 16));
  const __m512i ns = _mm512_and_epi32(e, _mm512_set1_epi32(63));
  const __m512i adv = _mm512_and_epi32(_mm512_srli_epi32(e, 6), one);
  const __mmask16 advk = _mm512_test_epi32_mask(adv, adv);
  const __mmask16 eobk = _mm512_test_epi32_mask(e, _mm512_set1_epi32(128));
  const __m512i va = _mm512_and_epi32(_mm512_srli_epi32(e, 8), c255);
  const __m512i vm = _mm512_and_epi32(_mm512_srli_epi32(e, 16),
                                      _mm512_set1_epi32(3));
  const __m512i vb = _mm512_and_epi32(_mm512_srli_epi32(e, 18),
                                      _mm512_set1_epi32(3));
  const __m512i vold = v;
  v = _mm512_add_epi32(
      _mm512_add_epi32(_mm512_mullo_epi32(vold, vm),
                       _mm512_mullo_epi32(bitv, vb)),
      va);
  const __mmask16 s2k =
      _mm512_cmpeq_epi32_mask(state, _mm512_set1_epi32(S2));
  nctx = _mm512_mask_add_epi32(nctx, s2k, bitv, one);
  // coefficient store (masked scatter into the lane staging blocks)
  const __mmask16 signk =
      _mm512_cmpeq_epi32_mask(state, _mm512_set1_epi32(SIGN));
  const __m512i negv = _mm512_sub_epi32(zero, bitv);
  const __m512i sv = _mm512_add_epi32(_mm512_xor_epi32(vold, negv), bitv);
  const __mmask16 nzk = _mm512_test_epi32_mask(n, _mm512_set1_epi32(~0));
  const __m512i dq = _mm512_mask_mov_epi32(dq0, nzk, dq1);
  const __m512i val = _mm512_mullo_epi32(sv, dq);
  // zigzag position via register permute (n <= 15 whenever a store
  // happens; the stored lane's n only reaches 16 together with done)
  const __m512i zz_tab = _mm512_setr_epi32(0, 1, 4, 8, 5, 2, 3, 6, 9, 12,
                                           13, 10, 7, 11, 14, 15);
  const __m512i zz = _mm512_permutexvar_epi32(n, zz_tab);
  const __m512i lane16 = _mm512_slli_epi32(
      _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                        15),
      4);
  _mm512_mask_i32scatter_epi32(staging_base, signk,
                               _mm512_add_epi32(lane16, zz), val, 4);
  const __m512i nn = _mm512_add_epi32(n, adv);
  n = nn;
  // Band-row advance via register permute: bo = (kBands[nn]*3+csel)*40.
  // nn==16 (block complete) wraps to kBands[0] — harmless, the lane is
  // re-armed by the slow path before the value is ever used.
  const __m512i csel = _mm512_maskz_mov_epi32(signk, nctx);
  const __m512i kb_tab = _mm512_setr_epi32(0, 1, 2, 3, 6, 4, 5, 6, 6, 6,
                                           6, 6, 6, 6, 6, 7);
  const __m512i kb3 = _mm512_add_epi32(
      _mm512_mullo_epi32(_mm512_permutexvar_epi32(nn, kb_tab),
                         _mm512_set1_epi32(3)),
      csel);
  const __m512i bo = _mm512_mullo_epi32(kb3, _mm512_set1_epi32(PV_STRIDE));
  pv_off = _mm512_mask_add_epi32(pv_off, advk, pv_base, bo);
  state = ns;
  prob = _mm512_and_epi32(
      _mm512_i32gather_epi32(_mm512_add_epi32(pv_off, ns),
                             (const int*)eng.pv_arena, 1),
      c255);
  // done = eob | (adv & nn>=16), active lanes only
  const __mmask16 n16k =
      _mm512_cmpge_epi32_mask(nn, _mm512_set1_epi32(16));
  return (uint16_t)((eobk | (advk & n16k)) & active);
}

static bool any_blocked_lane(const Engine& eng) {
  for (int k = 0; k < NLANES; k++)
    if (eng.lanes[k].img && eng.lanes[k].blocked && !eng.lanes[k].done)
      return true;
  return false;
}

static void flag_deadlocked(Engine& eng) {
  for (int k = 0; k < NLANES; k++)
    if (eng.lanes[k].img && eng.lanes[k].blocked && !eng.lanes[k].done)
      eng.lanes[k].img->error = 1;
  for (auto& p : eng.pending)
    if (p.img && !p.done) p.img->error = 1;
}

// Per-group register block (16 lanes).  Two of these step alternately
// so one group's serial gather->state chain overlaps the other's.
struct GroupRegs {
  __m512i value, range, bits, buf_off, state, n, v, nctx;
  __m512i pv_off, pv_base, dq0, dq1, prob;
};

static inline void group_load(GroupRegs& r, Hot& h, int g) {
  const int o = 16 * g;
  r.value = _mm512_loadu_si512(h.value + o);
  r.range = _mm512_loadu_si512(h.range + o);
  r.bits = _mm512_loadu_si512(h.bits + o);
  r.buf_off = _mm512_loadu_si512(h.buf_off + o);
  r.state = _mm512_loadu_si512(h.state + o);
  r.n = _mm512_loadu_si512(h.n + o);
  r.v = _mm512_loadu_si512(h.v + o);
  r.nctx = _mm512_loadu_si512(h.nctx + o);
  r.pv_off = _mm512_loadu_si512(h.pv_off + o);
  r.pv_base = _mm512_loadu_si512(h.pv_base + o);
  r.dq0 = _mm512_loadu_si512(h.dq0 + o);
  r.dq1 = _mm512_loadu_si512(h.dq1 + o);
  r.prob = _mm512_loadu_si512(h.prob + o);
}

static inline void group_spill5(const GroupRegs& r, Hot& h, int g) {
  const int o = 16 * g;
  _mm512_storeu_si512(h.value + o, r.value);
  _mm512_storeu_si512(h.range + o, r.range);
  _mm512_storeu_si512(h.bits + o, r.bits);
  _mm512_storeu_si512(h.buf_off + o, r.buf_off);
  _mm512_storeu_si512(h.n + o, r.n);
}

static inline void group_reload(GroupRegs& r, Engine& eng, Hot& h, int g,
                                uint16_t dirty) {
  if (!dirty) return;
  const int o = 16 * g;
  // bool-decoder fields only change on park/unpark/install; plain
  // re-arms (the common case) spilled them unchanged
  const uint16_t bd =
      (uint16_t)((eng.bool_dirty >> o) & dirty);
  eng.bool_dirty &= ~((uint32_t)dirty << o);
  if (bd) {
    r.value = _mm512_mask_loadu_epi32(r.value, bd, h.value + o);
    r.range = _mm512_mask_loadu_epi32(r.range, bd, h.range + o);
    r.bits = _mm512_mask_loadu_epi32(r.bits, bd, h.bits + o);
    r.buf_off = _mm512_mask_loadu_epi32(r.buf_off, bd, h.buf_off + o);
  }
  r.state = _mm512_mask_loadu_epi32(r.state, dirty, h.state + o);
  r.n = _mm512_mask_loadu_epi32(r.n, dirty, h.n + o);
  r.v = _mm512_mask_loadu_epi32(r.v, dirty, h.v + o);
  r.nctx = _mm512_mask_loadu_epi32(r.nctx, dirty, h.nctx + o);
  r.pv_off = _mm512_mask_loadu_epi32(r.pv_off, dirty, h.pv_off + o);
  r.pv_base = _mm512_mask_loadu_epi32(r.pv_base, dirty, h.pv_base + o);
  r.dq0 = _mm512_mask_loadu_epi32(r.dq0, dirty, h.dq0 + o);
  r.dq1 = _mm512_mask_loadu_epi32(r.dq1, dirty, h.dq1 + o);
  r.prob = _mm512_mask_loadu_epi32(r.prob, dirty, h.prob + o);
}

static inline uint16_t group_step(Engine& eng, GroupRegs& r, int g,
                                  uint16_t active16) {
  return step_avx512(eng, eng.staging + (size_t)16 * 16 * g, r.value,
                     r.range, r.bits, r.buf_off, r.state, r.n, r.v,
                     r.nctx, r.pv_off, r.pv_base, r.dq0, r.dq1, r.prob,
                     active16);
}

static void run_avx512(Engine& eng) {
  Hot& h = eng.hot;
  GroupRegs A, B;
  group_load(A, h, 0);
  group_load(B, h, 1);
  for (;;) {
    if (!eng.active) {
      uint32_t before = eng.active;
      retry_blocked(eng);
      if (!eng.active) {
        if (any_blocked_lane(eng) || !eng.pending.empty())
          flag_deadlocked(eng);
        return;
      }
      uint32_t dirty = before ^ eng.active;
      group_reload(A, eng, h, 0, (uint16_t)dirty);
      group_reload(B, eng, h, 1, (uint16_t)(dirty >> 16));
    }
    const uint16_t actA = (uint16_t)eng.active;
    const uint16_t actB = (uint16_t)(eng.active >> 16);
    uint16_t doneA = 0, doneB = 0;
    if (actB) {
      do {
        doneA = group_step(eng, A, 0, actA);
        doneB = group_step(eng, B, 1, actB);
      } while (!(doneA | doneB));
    } else {
      // small batches never fill group B; don't burn cycles on it
      do {
        doneA = group_step(eng, A, 0, actA);
      } while (!doneA);
    }
    // Spill only what the slow path reads (n = the block's nz,
    // buf_off for the exhaustion check, plus the bool state that
    // park_lane may stash); everything else is a pure output of
    // arm_block and comes back via the dirty reload.
    if (doneA) group_spill5(A, h, 0);
    if (doneB) group_spill5(B, h, 1);
    const uint32_t before = eng.active;
    uint32_t done = (uint32_t)doneA | ((uint32_t)doneB << 16);
    uint32_t dirty = done;
    while (done) {
      int k = __builtin_ctz(done);
      done &= done - 1;
      lane_done(eng, k);
    }
    retry_blocked(eng);
    dirty |= before ^ eng.active;
    group_reload(A, eng, h, 0, (uint16_t)dirty);
    group_reload(B, eng, h, 1, (uint16_t)(dirty >> 16));
  }
}

#endif  // WTPU_AVX512

static void run_scalar(Engine& eng) {
  for (;;) {
    if (!eng.active) {
      retry_blocked(eng);
      if (!eng.active) {
        for (int k = 0; k < NLANES; k++)
          if (eng.lanes[k].img && eng.lanes[k].blocked &&
              !eng.lanes[k].done)
            eng.lanes[k].img->error = 1;
        for (auto& p : eng.pending)
          if (p.img && !p.done) p.img->error = 1;
        return;
      }
    }
    uint32_t done = 0;
    for (int k = 0; k < NLANES; k++) {
      if (!(eng.active & (1u << k))) continue;
      if (step_scalar(eng, k)) done |= 1u << k;
    }
    while (done) {
      int k = __builtin_ctz(done);
      done &= done - 1;
      lane_done(eng, k);
    }
    retry_blocked(eng);
    bool any_active = eng.active != 0;
    if (!any_active && eng.pending.empty()) {
      bool any_blocked = false;
      for (int k = 0; k < NLANES; k++)
        if (eng.lanes[k].img && eng.lanes[k].blocked && !eng.lanes[k].done)
          any_blocked = true;
      if (!any_blocked) return;
      for (int k = 0; k < NLANES; k++)
        if (eng.lanes[k].img && eng.lanes[k].blocked && !eng.lanes[k].done)
          eng.lanes[k].img->error = 1;
      return;
    }
  }
}

// ----------------------------------------------------------------------
// Sequential mode pre-pass (partition 0): segment, skip, modes.
// Mirrors parse_frame_mbs' mode section (vp8_dec.cpp), but on a
// branchless boolean decoder (mask selects + clz renorm): the decision
// outcomes are data-random, so the branchy RFC form mispredicts every
// other decision (~9 ns/get vs ~5.5 branchless).
// ----------------------------------------------------------------------
struct FastModeDec {
  const uint8_t* data;
  uint64_t size;
  uint64_t pos;
  uint32_t value;   // libwebp convention: window bits, range as real-1
  uint32_t range;
  int32_t bits;

  // Seed from RFC-convention state (pos/value/range/bit_count): the
  // RFC value is [window:8][future:8-bc valid][bc dead zeros], so the
  // window representation here is value_rfc >> bc with 8-bc lookahead
  // bits, and range is stored as real-1.
  void init(const uint8_t* d, uint64_t n, uint64_t p, uint32_t v,
            uint32_t r, int bc) {
    data = d; size = n; pos = p;
    value = v >> bc; bits = 8 - bc; range = r - 1;
  }
  inline uint32_t next_byte() {
    uint32_t b = pos < size ? data[pos] : 0;
    pos++;
    return b;
  }
  inline int get(int prob) {
    if (bits < 0) {
      value = (value << 8) | next_byte();
      bits += 8;
    }
    const int p = bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t vv = (value >> p) & 0xff;
    const uint32_t bit = vv > split;
    const uint32_t mask = 0 - bit;
    const uint32_t r_sel = (split + 1) + (mask & (range - 2 * split - 1));
    value -= ((split + 1) & mask) << p;
    const int shift = __builtin_clz(r_sel) - 24;
    bits = p - shift;
    range = (r_sel << shift) - 1;
    return (int)bit;
  }
  inline bool exhausted() const { return pos > size + 4; }
};

static int parse_modes(FastModeDec& bd, int mb_w, int mb_h, int update_map,
                       const uint8_t* segment_probs, int use_skip,
                       int skip_p, uint8_t* modes_out) {
  std::vector<uint8_t> intra_t((size_t)4 * mb_w, 0);
  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      uint8_t* m = modes_out + ((size_t)mb_y * mb_w + mb_x) * 21;
      uint8_t segment = 0;
      if (update_map) {
        if (!bd.get(segment_probs[0]))
          segment = (uint8_t)bd.get(segment_probs[1]);
        else
          segment = (uint8_t)(2 + bd.get(segment_probs[2]));
      }
      uint8_t skip = use_skip ? (uint8_t)bd.get(skip_p) : 0;
      uint8_t is_i4 = (uint8_t)(!bd.get(145));
      uint8_t* top4 = intra_t.data() + 4 * mb_x;
      if (!is_i4) {
        int ymode;
        if (bd.get(156)) ymode = bd.get(128) ? 1 : 3;   // TM : HE
        else ymode = bd.get(163) ? 2 : 0;               // VE : DC
        for (int i = 0; i < 16; i++) m[5 + i] = (uint8_t)ymode;
        std::memset(top4, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        for (int yy = 0; yy < 4; yy++) {
          int ymode = intra_l[yy];
          for (int xx = 0; xx < 4; xx++) {
            const uint8_t* prob = kBModeProbas + (top4[xx] * 10 + ymode) * 9;
            int i = kBModeTree[bd.get(prob[0])];
            while (i > 0) i = kBModeTree[2 * i + bd.get(prob[i])];
            ymode = -i;
            top4[xx] = (uint8_t)ymode;
            m[5 + 4 * yy + xx] = (uint8_t)ymode;
          }
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      uint8_t uvmode;
      if (!bd.get(142)) uvmode = 0;
      else if (!bd.get(114)) uvmode = 2;
      else uvmode = bd.get(183) ? 1 : 3;
      m[0] = is_i4;
      m[1] = uvmode;
      m[2] = segment;
      m[3] = skip;
      m[4] = 0;
    }
    if (bd.exhausted()) return 2;
  }
  return 0;
}

}  // namespace

extern "C" {

// 1 when the engine was built with the AVX-512 vector step.  The
// scalar round-robin fallback is correct but slower than the
// single-stream per-image decoder, so the Python layer routes around
// it on non-vector builds.
int wtpu_vp8_batch_is_vectorized(void) {
#ifdef WTPU_AVX512
  return 1;
#else
  return 0;
#endif
}

// Interleaved batch symbol decode.  Per-image arrays are passed as
// flat buffers with element-offset tables (ctypes-friendly).  Outputs
// and semantics match wtpu_vp8_decode_symbols exactly; rc_out[i] is
// the per-image status (0 ok, 1 token exhausted, 2 partition-0
// exhausted).  Returns the number of failed images.
int wtpu_vp8_decode_symbols_batch(
    int n_img,
    const uint8_t* p0_all, const uint64_t* p0_off,         // [n+1] bytes
    const uint64_t* p0_pos, const uint32_t* p0_value,
    const uint32_t* p0_range, const uint32_t* p0_bitcount,
    const uint8_t* parts_all, const uint64_t* parts_off,   // [n+1] bytes
    const uint64_t* part_bounds, const int32_t* part_bounds_off,
    const int32_t* num_parts,                               // [n]
    const int32_t* mb_dims,                                 // [n][2]
    const int32_t* hdr_flags,                               // [n][3]
    const uint8_t* seg_probs_all,                           // [n][3]
    const uint8_t* coeff_probs_all,                         // [n][1056]
    const int32_t* quants_all,                              // [n][24]
    int16_t* coeffs_all, const uint64_t* coeffs_off,        // [n+1] elems
    uint8_t* modes_all, const uint64_t* modes_off,          // [n+1] bytes
    int32_t* rc_out) {
  std::vector<ImageCtx> imgs(n_img);
  int n_failed = 0;

  // shared arenas: padded partition bytes + expanded prob rows
  constexpr uint64_t kGuard = 4096;
  uint64_t arena_sz = 64, pv_sz = 64;
  for (int i = 0; i < n_img; i++) {
    const uint64_t* bounds = part_bounds + part_bounds_off[i];
    arena_sz += bounds[num_parts[i]] + kGuard * num_parts[i];
    pv_sz += 4 * 8 * 3 * PV_STRIDE;
  }
  std::vector<uint8_t> arena(arena_sz, 0);
  std::vector<uint8_t> pv_arena(pv_sz + 64, 0);
  uint64_t aw = 0, pw = 0;
  std::vector<std::vector<uint32_t>> part_starts(n_img);

  Engine eng;
  std::memset(&eng.hot, 0, sizeof(eng.hot));
  std::memset(eng.staging, 0, sizeof(eng.staging));

  for (int i = 0; i < n_img; i++) {
    ImageCtx& im = imgs[i];
    im.mb_w = mb_dims[2 * i];
    im.mb_h = mb_dims[2 * i + 1];
    im.num_parts = num_parts[i];
    im.quants = quants_all + (size_t)i * 24;
    im.use_skip = hdr_flags[3 * i + 1];
    im.coeffs_out = coeffs_all + coeffs_off[i];
    im.modes_out = modes_all + modes_off[i];
    std::memset(im.modes_out, 0, modes_off[i + 1] - modes_off[i]);
    rc_out[i] = 0;

    FastModeDec bd;
    bd.init(p0_all + p0_off[i], p0_off[i + 1] - p0_off[i], p0_pos[i],
            p0_value[i], p0_range[i], (int)p0_bitcount[i]);
    int rc = parse_modes(bd, im.mb_w, im.mb_h, hdr_flags[3 * i],
                         seg_probs_all + (size_t)i * 3,
                         hdr_flags[3 * i + 1], hdr_flags[3 * i + 2],
                         im.modes_out);
    if (rc != 0) {
      rc_out[i] = rc;
      n_failed++;
      continue;
    }

    im.above_nz.assign(im.mb_w, 0);
    im.above_dc.assign(im.mb_w, 0);
    im.prog.assign(im.mb_h, 0);
    im.pv_off = (uint32_t)pw;
    expand_probs(coeff_probs_all + (size_t)i * 4 * 8 * 3 * 11,
                 pv_arena.data() + pw);
    pw += 4 * 8 * 3 * PV_STRIDE;

    const uint8_t* pbase = parts_all + parts_off[i];
    const uint64_t* bounds = part_bounds + part_bounds_off[i];
    for (int p = 0; p < im.num_parts && p < im.mb_h; p++) {
      uint64_t len = bounds[p + 1] - bounds[p];
      std::memcpy(arena.data() + aw, pbase + bounds[p], len);
      Lane src;
      src.img = &im;
      src.part = p;
      src.mb_x = 0;
      src.mb_y = p;
      src.buf_start = (uint32_t)aw;
      src.buf_size = len;
      eng.pending.push_back(src);
      aw += len + kGuard;
    }
  }

  eng.arena = arena.data();
  eng.pv_arena = pv_arena.data();
  for (int k = 0; k < NLANES; k++) park_lane(eng, k);
  // Install pending streams into lanes, preferring round-robin across
  // images so multi-partition gates don't all start blocked.
  {
    std::vector<Lane> pend;
    pend.swap(eng.pending);
    // reverse so pop_back() order matches submission order
    for (auto it = pend.rbegin(); it != pend.rend(); ++it)
      eng.pending.push_back(*it);
  }
  for (int k = 0; k < NLANES; k++) {
    if (eng.active & (1u << k)) continue;
    // retry the same lane until something sticks (a stream may finish
    // instantly — e.g. an all-skip image — or block on its gate)
    while (!eng.pending.empty()) {
      Lane src = eng.pending.back();
      eng.pending.pop_back();
      if (install_stream(eng, k, src)) break;
      if (eng.lanes[k].blocked) {
        eng.n_blocked++;
        break;   // parked in this lane, retried later
      }
    }
  }

#ifdef WTPU_AVX512
  run_avx512(eng);
#else
  run_scalar(eng);
#endif

  for (int i = 0; i < n_img; i++) {
    if (imgs[i].error && rc_out[i] == 0) {
      rc_out[i] = 1;
      n_failed++;
    }
  }
  return n_failed;
}

}  // extern "C"
