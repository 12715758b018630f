// VP8 lossy decode, host half: the single-stream symbol decoder.
//
// Python parses the frame headers and hands over the boolean-decoder
// state plus the finalized probability and quantizer tables; this file
// runs the per-MB hot loop (intra-mode parsing and coefficient token
// decode) and writes dense per-MB arrays: dequantized coefficients and
// modes.  Reconstruction, the loop filter and the colour conversion run
// on the device (ops/vp8_recon.py, ops/yuv.py and the yuv420_to_rgba
// kernel).  vp8_dec_batch.cpp is the interleaved multi-stream twin of
// wtpu_vp8_decode_symbols; both give identical arrays.
//
// Written from RFC 6386.

#include <cstdint>
#include <cstring>
#include <vector>

#include "vp8_tables.h"

namespace {

// ----------------------------------------------------------------------
// Boolean decoder (RFC 6386 convention, 8-bit window).
// ----------------------------------------------------------------------
struct BoolDec {
  const uint8_t* data;
  uint64_t size;
  uint64_t pos;
  uint32_t value;
  uint32_t range;
  int bit_count;

  void init(const uint8_t* d, uint64_t n) {
    data = d; size = n; pos = 0; value = 0; range = 255; bit_count = 0;
    value = (uint32_t)next_byte() << 8;
    value |= next_byte();
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
      ret = 1;
      range -= split;
      value -= big;
    } else {
      ret = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next_byte();
      }
    }
    return ret;
  }
  inline int flag() { return get(128); }
  inline int signed_value(int v) { return get(128) ? -v : v; }
  inline bool exhausted() const { return pos > size + 4; }
};

// ----------------------------------------------------------------------
// Fast boolean decoder: 56-bit prefetch, branchless CLZ renormalization
// (libwebp's classic representation: range stored as range-1; the RFC
// arithmetic maps 1:1 — split_stored = split_rfc - 1).
// Used for the token partitions (initialized fresh from raw bytes).
// ----------------------------------------------------------------------
struct FastBoolDec {
  const uint8_t* buf;
  const uint8_t* buf_end;
  uint64_t value;
  uint32_t range;   // stored as real_range - 1, in [126, 253]
  int bits;         // current bit position; < 0 means "needs load"
  int eof;
  int virtual_bytes;

  void init(const uint8_t* d, uint64_t n) {
    buf = d;
    buf_end = d + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    virtual_bytes = 0;
  }
  inline void load() {
    if (buf + 8 <= buf_end) {
      uint64_t in;
      std::memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else {
      // Final bytes, one at a time; then virtual zeros.
      while (bits < 0) {
        if (buf < buf_end) {
          value = (value << 8) | *buf++;
        } else {
          value <<= 8;
          if (++virtual_bytes > 4) eof = 1;
        }
        bits += 8;
      }
    }
  }
  inline int get(int prob) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos) & 0xff;
    // Branchless select: the (v > split) outcome is data-random, so a
    // conditional branch here mispredicts ~50% of the time and costs
    // ~15-20 cycles per token.  cmov/setcc + multiply-by-bit keep the
    // pipeline full (measured ~1.6x on the symbol phase).
    const int bit = v > split;
    const uint32_t r_sel = bit ? range - split : split + 1;
    value -= (uint64_t)(bit ? split + 1 : 0) << pos;
    const int shift = 7 ^ (31 - __builtin_clz(r_sel));
    bits -= shift;
    range = (r_sel << shift) - 1;
    return bit;
  }
  inline int signed_value(int v) { return get(128) ? -v : v; }
  inline bool exhausted() const { return eof; }
};

// ----------------------------------------------------------------------
// Frame state
// ----------------------------------------------------------------------
struct MB {
  uint8_t segment;
  uint8_t skip;       // skip flag from stream; updated to "empty" result
  uint8_t is_i4;
  uint8_t ymode;
  uint8_t uvmode;
  uint8_t dither;     // 1 = flat chroma (no uv AC), eligible for dithering
  uint8_t imodes[16];
  uint8_t has_nz[24];         // per 4x4 block: any dequantized coeff != 0
  int16_t coeffs[25][16];     // dequantized, raster order within block
};

struct Ctx {
  uint32_t nz = 0;
  uint32_t nz_dc = 0;
};

// ----------------------------------------------------------------------
// Coefficient decode
// ----------------------------------------------------------------------
template <typename BD>
static int get_large_value(BD& bd, const uint8_t* p) {
  int v;
  if (!bd.get(p[3])) {
    if (!bd.get(p[4])) v = 2;
    else v = 3 + bd.get(p[5]);
  } else if (!bd.get(p[6])) {
    if (!bd.get(p[7])) v = 5 + bd.get(159);
    else { v = 7 + 2 * bd.get(165); v += bd.get(145); }
  } else {
    int bit1 = bd.get(p[8]);
    int bit0 = bd.get(p[9 + bit1]);
    int cat = 2 * bit1 + bit0;
    v = 0;
    const uint8_t* tab = kCatProbas[cat];
    for (int i = 0; i < kCatBits[cat]; i++) v += v + bd.get(tab[i]);
    v += 3 + (8 << cat);
  }
  return v;
}

// probs_t: [8][3][11] for this block type; dq = {dc, ac}.
template <typename BD>
static int get_coeffs(BD& bd, const uint8_t* probs_t, int ctx,
                      int dq_dc, int dq_ac, int first, int16_t* out) {
  const uint8_t* p = probs_t + (kBands[first] * 3 + ctx) * 11;
  int n = first;
  while (n < 16) {
    if (!bd.get(p[0])) return n;
    while (!bd.get(p[1])) {
      n++;
      if (n == 16) return 16;
      p = probs_t + (kBands[n] * 3 + 0) * 11;
    }
    int v, next_ctx;
    if (!bd.get(p[2])) { v = 1; next_ctx = 1; }
    else { v = get_large_value(bd, p); next_ctx = 2; }
    out[kZigzag[n]] = (int16_t)(bd.signed_value(v) * (n > 0 ? dq_ac : dq_dc));
    p = probs_t + (kBands[n + 1] * 3 + next_ctx) * 11;
    n++;
  }
  return 16;
}

static void iwht4x4(const int16_t* in, int32_t* out) {
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

// Entropy-decode phase: partition-0 mode parse + token-partition
// residual decode into dequantized per-MB coefficient blocks.  Returns 0
// on success.
static int parse_frame_mbs(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs, const int32_t* quants,
    std::vector<MB>& mbs) {
  BoolDec bd;
  bd.data = p0; bd.size = p0_size; bd.pos = p0_pos;
  bd.value = p0_value; bd.range = p0_range; bd.bit_count = (int)p0_bitcount;

  std::vector<FastBoolDec> tparts(num_parts);
  for (int i = 0; i < num_parts; i++)
    tparts[i].init(parts + part_offsets[i],
                   part_offsets[i + 1] - part_offsets[i]);

  std::vector<uint8_t> intra_t((size_t)4 * mb_w, 0);
  std::vector<Ctx> ctx_above(mb_w);

  for (int mb_y = 0; mb_y < mb_h; mb_y++) {
    uint8_t intra_l[4] = {0, 0, 0, 0};
    Ctx ctx_left;
    FastBoolDec& tb = tparts[mb_y & (num_parts - 1)];
    // --- mode parsing for the row (partition 0) ---
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
      std::memset(mb.has_nz, 0, sizeof(mb.has_nz));
      mb.segment = 0;
      if (update_map) {
        if (!bd.get(segment_probs[0])) mb.segment = (uint8_t)bd.get(segment_probs[1]);
        else mb.segment = (uint8_t)(2 + bd.get(segment_probs[2]));
      }
      mb.skip = use_skip ? (uint8_t)bd.get(skip_p) : 0;
      mb.is_i4 = (uint8_t)(!bd.get(145));
      uint8_t* top4 = intra_t.data() + 4 * mb_x;
      if (!mb.is_i4) {
        int ymode;
        if (bd.get(156)) ymode = bd.get(128) ? 1 : 3;   // TM : HE
        else ymode = bd.get(163) ? 2 : 0;               // VE : DC
        mb.ymode = (uint8_t)ymode;
        for (int i = 0; i < 16; i++) mb.imodes[i] = (uint8_t)ymode;
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
            mb.imodes[4 * yy + xx] = (uint8_t)ymode;
          }
          intra_l[yy] = (uint8_t)ymode;
        }
      }
      if (!bd.get(142)) mb.uvmode = 0;
      else if (!bd.get(114)) mb.uvmode = 2;
      else mb.uvmode = bd.get(183) ? 1 : 3;
    }
    // --- residuals (token partition) ---
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      Ctx& above = ctx_above[mb_x];
      const int32_t* q = quants + mb.segment * 6;
      int skip = use_skip ? mb.skip : 0;
      if (skip) {
        above.nz = 0;
        ctx_left.nz = 0;
        if (!mb.is_i4) { above.nz_dc = 0; ctx_left.nz_dc = 0; }
        mb.skip = 1;
        mb.dither = 0;  // explicitly skipped MBs are never dithered
      } else {
        const uint8_t* probs0 = coeff_probs + 0 * 8 * 3 * 11;
        const uint8_t* probs1 = coeff_probs + 1 * 8 * 3 * 11;
        const uint8_t* probs2 = coeff_probs + 2 * 8 * 3 * 11;
        const uint8_t* probs3 = coeff_probs + 3 * 8 * 3 * 11;
        int first;
        const uint8_t* ac_probs;
        uint32_t any_nz = 0;
        if (!mb.is_i4) {
          int16_t dc[16] = {0};
          int ctx = (int)(above.nz_dc + ctx_left.nz_dc);
          int nz = get_coeffs(tb, probs1, ctx, q[2], q[3], 0, dc);
          above.nz_dc = ctx_left.nz_dc = (nz > 0);
          any_nz |= (nz > 0);
          int32_t dcs[16];
          if (nz > 1) {
            iwht4x4(dc, dcs);
          } else {
            int32_t dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16; i++) dcs[i] = dc0;
          }
          for (int i = 0; i < 16; i++) mb.coeffs[i][0] = (int16_t)dcs[i];
          first = 1;
          ac_probs = probs0;
        } else {
          first = 0;
          ac_probs = probs3;
        }
        uint32_t tnz = above.nz & 0x0f, lnz = ctx_left.nz & 0x0f;
        for (int yy = 0; yy < 4; yy++) {
          uint32_t l = lnz & 1;
          for (int xx = 0; xx < 4; xx++) {
            int ctx = (int)(l + (tnz & 1));
            int bi = 4 * yy + xx;
            int nz = get_coeffs(tb, ac_probs, ctx, q[0], q[1], first,
                                mb.coeffs[bi]);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            // has_nz: any dequantized coefficient present (incl. WHT dc).
            bool has = nz > first || mb.coeffs[bi][0] != 0;
            mb.has_nz[bi] = has;
            any_nz |= (uint32_t)has;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        bool uv_ac = false;  // any chroma block with a coeff beyond index 0
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = (above.nz >> (4 + ch)) & 0xff;
          lnz = (ctx_left.nz >> (4 + ch)) & 0xff;
          uint32_t l = 0;
          for (int yy = 0; yy < 2; yy++) {
            l = lnz & 1;
            for (int xx = 0; xx < 2; xx++) {
              int ctx = (int)(l + (tnz & 1));
              int bi = 16 + 2 * ch + 2 * yy + xx;
              int nz = get_coeffs(tb, probs2, ctx, q[4], q[5], 0,
                                  mb.coeffs[bi]);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              mb.has_nz[bi] = nz > 0;
              any_nz |= (uint32_t)(nz > 0);
              uv_ac |= nz > 1;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xf0) << ch;
        }
        above.nz = out_t;
        ctx_left.nz = out_l;
        mb.skip = !any_nz;
        // Reference vp8_dec.go:693-699: dither only flat-chroma MBs.
        mb.dither = uv_ac ? 0 : 1;
        if (tb.exhausted()) return 1;
      }
    }
    if (bd.exhausted()) return 2;
  }
  return 0;
}

}  // namespace

extern "C" {

// modes_out: uint8 [mb_h*mb_w][21]: [0]=is_i4, [1]=uvmode, [2]=segment,
//   [3]=skip (1 = MB fully empty), [4]=dither-eligible, [5..20]=imodes
//   (i16 MBs: ymode replicated).
// Coefficient-probability update block (RFC 6386 9.8-9.11): the
// ~1100-decision tail of the frame header.  Pure-Python parsing of
// this block costs ~1 ms per image and serializes the batch decoder's
// thread pool on the GIL; this native twin runs it in ~10 us.
// state: in/out [pos, value, range, bit_count]; returns use_skip<<8 |
// skip_p packed, or -1 on exhaustion.
int wtpu_vp8_parse_probs(
    const uint8_t* data, uint64_t size, uint64_t* state,
    const uint8_t* update_probs,      // [1056]
    uint8_t* probs /* inout [1056] */) {
  BoolDec bd;
  bd.data = data; bd.size = size; bd.pos = state[0];
  bd.value = (uint32_t)state[1]; bd.range = (uint32_t)state[2];
  bd.bit_count = (int)state[3];
  bd.flag();   // refresh_entropy_probs (always set for keyframes)
  for (int i = 0; i < 1056; i++) {
    if (bd.get(update_probs[i])) {
      int v = 0;
      for (int b = 0; b < 8; b++) v = (v << 1) | bd.flag();
      probs[i] = (uint8_t)v;
    }
  }
  int use_skip = bd.flag();
  int skip_p = 0;
  if (use_skip) {
    for (int b = 0; b < 8; b++) skip_p = (skip_p << 1) | bd.flag();
  }
  if (bd.exhausted()) return -1;
  state[0] = bd.pos;
  state[1] = bd.value;
  state[2] = bd.range;
  state[3] = (uint64_t)bd.bit_count;
  return (use_skip << 8) | skip_p;
}

int wtpu_vp8_decode_symbols(
    const uint8_t* p0, uint64_t p0_size, uint64_t p0_pos, uint32_t p0_value,
    uint32_t p0_range, uint32_t p0_bitcount,
    const uint8_t* parts, const uint64_t* part_offsets, int num_parts,
    int mb_w, int mb_h,
    int update_map, const uint8_t* segment_probs,
    int use_skip, int skip_p,
    const uint8_t* coeff_probs,          // [4][8][3][11]
    const int32_t* quants,               // [4][6]
    int16_t* coeffs_out, uint8_t* modes_out) {
  std::vector<MB> mbs((size_t)mb_w * mb_h);
  int rc = parse_frame_mbs(p0, p0_size, p0_pos, p0_value, p0_range,
                           p0_bitcount, parts, part_offsets, num_parts,
                           mb_w, mb_h, update_map, segment_probs,
                           use_skip, skip_p, coeff_probs, quants, mbs);
  if (rc != 0) return rc;
  const size_t n = (size_t)mb_w * mb_h;
  for (size_t i = 0; i < n; i++) {
    const MB& mb = mbs[i];
    std::memcpy(coeffs_out + i * 24 * 16, mb.coeffs, 24 * 16 * sizeof(int16_t));
    uint8_t* m = modes_out + i * 21;
    m[0] = mb.is_i4;
    m[1] = mb.uvmode;
    m[2] = mb.segment;
    m[3] = mb.skip;
    m[4] = mb.dither;
    std::memcpy(m + 5, mb.imodes, 16);
  }
  return 0;
}

}  // extern "C"
