// VP8 lossy decode, host half: the single-stream symbol decoder and the
// host reconstruction.
//
// Python parses the frame headers and hands over the boolean-decoder
// state plus the finalized probability and quantizer tables; this file
// runs the per-MB hot loop (intra-mode parsing and coefficient token
// decode) and writes dense per-MB arrays: dequantized coefficients and
// modes.  On the default path reconstruction, the loop filter and the
// colour conversion run on the device (ops/vp8_recon.py, ops/yuv.py and
// the yuv420_to_rgba kernel); vp8_dec_batch.cpp is the interleaved
// multi-stream twin of wtpu_vp8_decode_symbols, and both give identical
// arrays.  decode_rgba_batch(recon_backend="host") instead reconstructs
// from those arrays here (wtpu_vp8_recon_frame_arrays: intra prediction,
// iDCT and the in-loop deblocking filter) and converts with the fused
// fancy upsampler (wtpu_yuv_to_rgba_fancy), bit-identical to the device
// path.
//
// Written from RFC 6386.

#if defined(__SSE2__)
#include <immintrin.h>
#endif
#include <cmath>
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

inline int clip255i(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ----------------------------------------------------------------------
// iDCT (adds into dst with stride)
// ----------------------------------------------------------------------
static inline int mul1(int a) { return a + ((a * 20091) >> 16); }
static inline int mul2(int a) { return (a * 35468) >> 16; }

#ifdef __SSE4_1__
// 4 int32 lanes carry one column (pass 1) / one row (pass 2) each;
// bit-identical to the scalar butterflies below (same >>16 fixed-point
// products, same +4 >>3 rounding, saturating pack for the clip).
static inline __m128i mul1_v(__m128i a) {
  return _mm_add_epi32(a,
      _mm_srai_epi32(_mm_mullo_epi32(a, _mm_set1_epi32(20091)), 16));
}
static inline __m128i mul2_v(__m128i a) {
  return _mm_srai_epi32(_mm_mullo_epi32(a, _mm_set1_epi32(35468)), 16);
}

static void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  // Rows of `in` are the four frequency lines; lanes are columns i.
  __m128i r0 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 0)));
  __m128i r1 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 4)));
  __m128i r2 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 8)));
  __m128i r3 = _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)(in + 12)));
  __m128i a = _mm_add_epi32(r0, r2);
  __m128i b = _mm_sub_epi32(r0, r2);
  __m128i c = _mm_sub_epi32(mul2_v(r1), mul1_v(r3));
  __m128i d = _mm_add_epi32(mul1_v(r1), mul2_v(r3));
  __m128i C0 = _mm_add_epi32(a, d);            // C[0*4+i]
  __m128i C1 = _mm_add_epi32(b, c);
  __m128i C2 = _mm_sub_epi32(b, c);
  __m128i C3 = _mm_sub_epi32(a, d);
  // Transpose so lanes become rows: Vk[r] = C[r*4+k].
  __m128i t0 = _mm_unpacklo_epi32(C0, C1), t1 = _mm_unpackhi_epi32(C0, C1);
  __m128i t2 = _mm_unpacklo_epi32(C2, C3), t3 = _mm_unpackhi_epi32(C2, C3);
  __m128i V0 = _mm_unpacklo_epi64(t0, t2);
  __m128i V1 = _mm_unpackhi_epi64(t0, t2);
  __m128i V2 = _mm_unpacklo_epi64(t1, t3);
  __m128i V3 = _mm_unpackhi_epi64(t1, t3);
  __m128i dc = _mm_add_epi32(V0, _mm_set1_epi32(4));
  a = _mm_add_epi32(dc, V2);
  b = _mm_sub_epi32(dc, V2);
  c = _mm_sub_epi32(mul2_v(V1), mul1_v(V3));
  d = _mm_add_epi32(mul1_v(V1), mul2_v(V3));
  __m128i o0 = _mm_srai_epi32(_mm_add_epi32(a, d), 3);   // col 0, rows 0..3
  __m128i o1 = _mm_srai_epi32(_mm_add_epi32(b, c), 3);
  __m128i o2 = _mm_srai_epi32(_mm_sub_epi32(b, c), 3);
  __m128i o3 = _mm_srai_epi32(_mm_sub_epi32(a, d), 3);
  // Transpose back: lanes become columns within each output row.
  t0 = _mm_unpacklo_epi32(o0, o1); t1 = _mm_unpackhi_epi32(o0, o1);
  t2 = _mm_unpacklo_epi32(o2, o3); t3 = _mm_unpackhi_epi32(o2, o3);
  __m128i row0 = _mm_unpacklo_epi64(t0, t2);
  __m128i row1 = _mm_unpackhi_epi64(t0, t2);
  __m128i row2 = _mm_unpacklo_epi64(t1, t3);
  __m128i row3 = _mm_unpackhi_epi64(t1, t3);
  const __m128i rows[4] = {row0, row1, row2, row3};
  for (int r = 0; r < 4; r++) {
    uint8_t* o = dst + r * stride;
    int32_t w;
    std::memcpy(&w, o, 4);
    __m128i px = _mm_cvtepu8_epi32(_mm_cvtsi32_si128(w));
    __m128i s = _mm_add_epi32(px, rows[r]);
    __m128i p16 = _mm_packs_epi32(s, s);
    __m128i p8 = _mm_packus_epi16(p16, p16);
    w = _mm_cvtsi128_si32(p8);
    std::memcpy(o, &w, 4);
  }
}
#else
static void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int32_t C[16];
  for (int i = 0; i < 4; i++) {
    int32_t a = in[i] + in[8 + i];
    int32_t b = in[i] - in[8 + i];
    int32_t c = mul2(in[4 + i]) - mul1(in[12 + i]);
    int32_t d = mul1(in[4 + i]) + mul2(in[12 + i]);
    C[0 * 4 + i] = a + d;
    C[1 * 4 + i] = b + c;
    C[2 * 4 + i] = b - c;
    C[3 * 4 + i] = a - d;
  }
  for (int r = 0; r < 4; r++) {
    int32_t dc = C[r * 4 + 0] + 4;
    int32_t a = dc + C[r * 4 + 2];
    int32_t b = dc - C[r * 4 + 2];
    int32_t c = mul2(C[r * 4 + 1]) - mul1(C[r * 4 + 3]);
    int32_t d = mul1(C[r * 4 + 1]) + mul2(C[r * 4 + 3]);
    uint8_t* o = dst + r * stride;
    o[0] = (uint8_t)clip255i(o[0] + ((a + d) >> 3));
    o[1] = (uint8_t)clip255i(o[1] + ((b + c) >> 3));
    o[2] = (uint8_t)clip255i(o[2] + ((b - c) >> 3));
    o[3] = (uint8_t)clip255i(o[3] + ((a - d) >> 3));
  }
}
#endif  // __SSE4_1__

// ----------------------------------------------------------------------
// Intra predictors on a bordered working buffer.
// buf stride BUFS; (0,0) = top-left corner; data block at (1,1).
// ----------------------------------------------------------------------
constexpr int BUFS = 24;

static inline uint8_t* at(uint8_t* buf, int r, int c) { return buf + r * BUFS + c; }

static void pred_dc(uint8_t* buf, int x, int y, int size, bool ht, bool hl) {
  int v;
  if (ht && hl) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[y * BUFS + x + 1 + i] + buf[(y + 1 + i) * BUFS + x];
    v = (s + size) >> (size == 16 ? 5 : 4);
  } else if (hl) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[(y + 1 + i) * BUFS + x];
    v = (s + size / 2) >> (size == 16 ? 4 : 3);
  } else if (ht) {
    int s = 0;
    for (int i = 0; i < size; i++) s += buf[y * BUFS + x + 1 + i];
    v = (s + size / 2) >> (size == 16 ? 4 : 3);
  } else {
    v = 0x80;
  }
  for (int r = 0; r < size; r++)
    std::memset(buf + (y + 1 + r) * BUFS + x + 1, v, size);
}

static void pred_tm(uint8_t* buf, int x, int y, int size) {
  int tl = buf[y * BUFS + x];
  for (int r = 0; r < size; r++) {
    int l = buf[(y + 1 + r) * BUFS + x];
    uint8_t* o = buf + (y + 1 + r) * BUFS + x + 1;
    const uint8_t* t = buf + y * BUFS + x + 1;
    for (int c = 0; c < size; c++) o[c] = (uint8_t)clip255i(l + t[c] - tl);
  }
}

static void pred_ve(uint8_t* buf, int x, int y, int size) {
  for (int r = 0; r < size; r++)
    std::memcpy(buf + (y + 1 + r) * BUFS + x + 1, buf + y * BUFS + x + 1, size);
}

static void pred_he(uint8_t* buf, int x, int y, int size) {
  for (int r = 0; r < size; r++)
    std::memset(buf + (y + 1 + r) * BUFS + x + 1,
                buf[(y + 1 + r) * BUFS + x], size);
}

static void predict_block(uint8_t* buf, int x, int y, int size, int mode,
                          bool ht, bool hl) {
  switch (mode) {
    case 0: pred_dc(buf, x, y, size, ht, hl); break;
    case 1: pred_tm(buf, x, y, size); break;
    case 2: pred_ve(buf, x, y, size); break;
    case 3: pred_he(buf, x, y, size); break;
  }
}

#define AVG3(a, b, c) (((a) + 2 * (b) + (c) + 2) >> 2)
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void predict_luma4(uint8_t* buf, int x, int y, int mode) {
  // Context: top at row y, cols x+1..x+8 (incl. TR), left col x, TL at (y,x).
  const int A = buf[y * BUFS + x + 1], B = buf[y * BUFS + x + 2],
            C = buf[y * BUFS + x + 3], D = buf[y * BUFS + x + 4];
  const int E = buf[y * BUFS + x + 5], F = buf[y * BUFS + x + 6],
            G = buf[y * BUFS + x + 7], H = buf[y * BUFS + x + 8];
  const int I = buf[(y + 1) * BUFS + x], J = buf[(y + 2) * BUFS + x],
            K = buf[(y + 3) * BUFS + x], L = buf[(y + 4) * BUFS + x];
  const int X = buf[y * BUFS + x];
  uint8_t o[4][4];
  switch (mode) {
    case 0: {  // DC4
      int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      std::memset(o, v, 16);
      break;
    }
    case 1: {  // TM4
      for (int r = 0; r < 4; r++) {
        int l = buf[(y + 1 + r) * BUFS + x];
        for (int c = 0; c < 4; c++)
          o[r][c] = (uint8_t)clip255i(l + buf[y * BUFS + x + 1 + c] - X);
      }
      break;
    }
    case 2: {  // VE4
      uint8_t v[4] = {(uint8_t)AVG3(X, A, B), (uint8_t)AVG3(A, B, C),
                      (uint8_t)AVG3(B, C, D), (uint8_t)AVG3(C, D, E)};
      for (int r = 0; r < 4; r++) std::memcpy(o[r], v, 4);
      break;
    }
    case 3: {  // HE4
      uint8_t v[4] = {(uint8_t)AVG3(X, I, J), (uint8_t)AVG3(I, J, K),
                      (uint8_t)AVG3(J, K, L), (uint8_t)AVG3(K, L, L)};
      for (int r = 0; r < 4; r++) std::memset(o[r], v[r], 4);
      break;
    }
    case 4: {  // RD4
      o[3][0] = (uint8_t)AVG3(J, K, L);
      o[2][0] = o[3][1] = (uint8_t)AVG3(I, J, K);
      o[1][0] = o[2][1] = o[3][2] = (uint8_t)AVG3(X, I, J);
      o[0][0] = o[1][1] = o[2][2] = o[3][3] = (uint8_t)AVG3(A, X, I);
      o[0][1] = o[1][2] = o[2][3] = (uint8_t)AVG3(B, A, X);
      o[0][2] = o[1][3] = (uint8_t)AVG3(C, B, A);
      o[0][3] = (uint8_t)AVG3(D, C, B);
      break;
    }
    case 5: {  // VR4
      o[0][0] = o[2][1] = (uint8_t)AVG2(X, A);
      o[0][1] = o[2][2] = (uint8_t)AVG2(A, B);
      o[0][2] = o[2][3] = (uint8_t)AVG2(B, C);
      o[0][3] = (uint8_t)AVG2(C, D);
      o[3][0] = (uint8_t)AVG3(K, J, I);
      o[2][0] = (uint8_t)AVG3(J, I, X);
      o[1][0] = o[3][1] = (uint8_t)AVG3(I, X, A);
      o[1][1] = o[3][2] = (uint8_t)AVG3(X, A, B);
      o[1][2] = o[3][3] = (uint8_t)AVG3(A, B, C);
      o[1][3] = (uint8_t)AVG3(B, C, D);
      break;
    }
    case 6: {  // LD4
      o[0][0] = (uint8_t)AVG3(A, B, C);
      o[0][1] = o[1][0] = (uint8_t)AVG3(B, C, D);
      o[0][2] = o[1][1] = o[2][0] = (uint8_t)AVG3(C, D, E);
      o[0][3] = o[1][2] = o[2][1] = o[3][0] = (uint8_t)AVG3(D, E, F);
      o[1][3] = o[2][2] = o[3][1] = (uint8_t)AVG3(E, F, G);
      o[2][3] = o[3][2] = (uint8_t)AVG3(F, G, H);
      o[3][3] = (uint8_t)AVG3(G, H, H);
      break;
    }
    case 7: {  // VL4
      o[0][0] = (uint8_t)AVG2(A, B);
      o[0][1] = o[2][0] = (uint8_t)AVG2(B, C);
      o[0][2] = o[2][1] = (uint8_t)AVG2(C, D);
      o[0][3] = o[2][2] = (uint8_t)AVG2(D, E);
      o[1][0] = (uint8_t)AVG3(A, B, C);
      o[1][1] = o[3][0] = (uint8_t)AVG3(B, C, D);
      o[1][2] = o[3][1] = (uint8_t)AVG3(C, D, E);
      o[1][3] = o[3][2] = (uint8_t)AVG3(D, E, F);
      o[2][3] = (uint8_t)AVG3(E, F, G);
      o[3][3] = (uint8_t)AVG3(F, G, H);
      break;
    }
    case 8: {  // HD4
      o[0][0] = o[1][2] = (uint8_t)AVG2(I, X);
      o[1][0] = o[2][2] = (uint8_t)AVG2(J, I);
      o[2][0] = o[3][2] = (uint8_t)AVG2(K, J);
      o[3][0] = (uint8_t)AVG2(L, K);
      o[0][3] = (uint8_t)AVG3(A, B, C);
      o[0][2] = (uint8_t)AVG3(X, A, B);
      o[0][1] = o[1][3] = (uint8_t)AVG3(I, X, A);
      o[1][1] = o[2][3] = (uint8_t)AVG3(X, I, J);
      o[2][1] = o[3][3] = (uint8_t)AVG3(I, J, K);
      o[3][1] = (uint8_t)AVG3(J, K, L);
      break;
    }
    case 9: {  // HU4
      o[0][0] = (uint8_t)AVG2(I, J);
      o[0][2] = o[1][0] = (uint8_t)AVG2(J, K);
      o[1][2] = o[2][0] = (uint8_t)AVG2(K, L);
      o[0][1] = (uint8_t)AVG3(I, J, K);
      o[0][3] = o[1][1] = (uint8_t)AVG3(J, K, L);
      o[1][3] = o[2][1] = (uint8_t)AVG3(K, L, L);
      o[2][2] = o[2][3] = o[3][0] = o[3][1] = o[3][2] = o[3][3] = (uint8_t)L;
      break;
    }
  }
  for (int r = 0; r < 4; r++)
    std::memcpy(buf + (y + 1 + r) * BUFS + x + 1, o[r], 4);
}

// ----------------------------------------------------------------------
// Loop filter
// ----------------------------------------------------------------------
static inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }
static inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }
static inline int iabs(int v) { return v < 0 ? -v : v; }

static inline bool needs_filter(const uint8_t* p, int step, int thresh2) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2;
}
static inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > t) return false;
  return iabs(p3 - p2) <= it && iabs(p2 - p1) <= it && iabs(p1 - p0) <= it &&
         iabs(q3 - q2) <= it && iabs(q2 - q1) <= it && iabs(q1 - q0) <= it;
}
static inline bool hev(const uint8_t* p, int step, int thresh) {
  return iabs(p[-2 * step] - p[-step]) > thresh || iabs(p[step] - p[0]) > thresh;
}
static inline void do_filter2(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip255i(p0 + a2);
  p[0] = (uint8_t)clip255i(q0 - a1);
}
static inline void do_filter4(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip255i(p1 + a3);
  p[-step] = (uint8_t)clip255i(p0 + a2);
  p[0] = (uint8_t)clip255i(q0 - a1);
  p[step] = (uint8_t)clip255i(q1 - a3);
}
static inline void do_filter6(uint8_t* p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7;
  int a2 = (18 * a + 63) >> 7;
  int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip255i(p2 + a3);
  p[-2 * step] = (uint8_t)clip255i(p1 + a2);
  p[-step] = (uint8_t)clip255i(p0 + a1);
  p[0] = (uint8_t)clip255i(q0 - a1);
  p[step] = (uint8_t)clip255i(q1 - a2);
  p[2 * step] = (uint8_t)clip255i(q2 - a3);
}

// Edge filtering runs lane-parallel: the 8 pixels across the edge
// (p3..q3) for all 16 lanes along it are gathered into a contiguous
// local buffer, a fixed-trip branchless core processes the 16 lanes
// (int16 arithmetic, mask-blended stores — the scalar-host analog of
// the SIMD deblocking paths in the reference's dsp layer), and the
// touched rows are scattered back.  Chroma edges (8 lanes each) are
// paired: U in lanes 0-7, V in lanes 8-15, one core call for both.
typedef uint8_t EdgeBuf[8][16];

static inline void edge_gather(const uint8_t* p, int hstride, int vstride,
                               int n, int lane0, EdgeBuf b) {
  if (vstride == 1) {  // lanes contiguous (horizontal edges)
    for (int r = 0; r < 8; r++)
      std::memcpy(&b[r][lane0], p + (std::ptrdiff_t)(r - 4) * hstride, n);
    return;
  }
  for (int r = 0; r < 8; r++) {
    const uint8_t* src = p + (std::ptrdiff_t)(r - 4) * hstride;
    for (int j = 0; j < n; j++) b[r][lane0 + j] = src[(std::ptrdiff_t)j * vstride];
  }
}
static inline void edge_scatter(uint8_t* p, int hstride, int vstride, int n,
                                int lane0, const EdgeBuf b, int r0, int r1) {
  if (vstride == 1) {
    for (int r = r0; r <= r1; r++)
      std::memcpy(p + (std::ptrdiff_t)(r - 4) * hstride, &b[r][lane0], n);
    return;
  }
  for (int r = r0; r <= r1; r++) {
    uint8_t* dst = p + (std::ptrdiff_t)(r - 4) * hstride;
    for (int j = 0; j < n; j++) dst[(std::ptrdiff_t)j * vstride] = b[r][lane0 + j];
  }
}

#if defined(__SSE2__)
// Vertical edges: each lane's 8 pixels across the edge are contiguous.
// Load 16 rows x 8 bytes and byte-transpose into the 8x16 lane buffer
// (and back).  rows[j] points at pixel p3 of lane j.
static inline void tr_gather(const uint8_t* const rows[16], EdgeBuf b) {
  __m128i t[8];
  for (int k = 0; k < 8; k++) {
    __m128i a = _mm_loadl_epi64((const __m128i*)rows[2 * k]);
    __m128i c = _mm_loadl_epi64((const __m128i*)rows[2 * k + 1]);
    t[k] = _mm_unpacklo_epi8(a, c);  // col c of rows (2k,2k+1) at u16 slot c
  }
  __m128i w[4][2];  // [row group of 4][cols 0-3 | 4-7]
  for (int m = 0; m < 4; m++) {
    w[m][0] = _mm_unpacklo_epi16(t[2 * m], t[2 * m + 1]);
    w[m][1] = _mm_unpackhi_epi16(t[2 * m], t[2 * m + 1]);
  }
  for (int h = 0; h < 2; h++) {
    __m128i a01 = _mm_unpacklo_epi32(w[0][h], w[1][h]);  // cols 4h+0,4h+1 rows0-7
    __m128i b01 = _mm_unpackhi_epi32(w[0][h], w[1][h]);  // cols 4h+2,4h+3 rows0-7
    __m128i a23 = _mm_unpacklo_epi32(w[2][h], w[3][h]);  // rows8-15
    __m128i b23 = _mm_unpackhi_epi32(w[2][h], w[3][h]);
    _mm_storeu_si128((__m128i*)b[4 * h + 0], _mm_unpacklo_epi64(a01, a23));
    _mm_storeu_si128((__m128i*)b[4 * h + 1], _mm_unpackhi_epi64(a01, a23));
    _mm_storeu_si128((__m128i*)b[4 * h + 2], _mm_unpacklo_epi64(b01, b23));
    _mm_storeu_si128((__m128i*)b[4 * h + 3], _mm_unpackhi_epi64(b01, b23));
  }
}
static inline void tr_scatter(const EdgeBuf b, uint8_t* const rows[16]) {
  __m128i y[8];
  for (int r = 0; r < 8; r++) y[r] = _mm_loadu_si128((const __m128i*)b[r]);
  for (int half = 0; half < 2; half++) {
    __m128i t[4];  // rows (2k,2k+1) interleaved, lanes 8*half..8*half+7
    for (int k = 0; k < 4; k++)
      t[k] = half ? _mm_unpackhi_epi8(y[2 * k], y[2 * k + 1])
                  : _mm_unpacklo_epi8(y[2 * k], y[2 * k + 1]);
    __m128i ua = _mm_unpacklo_epi16(t[0], t[1]);  // lanes +0..3, rows0-3
    __m128i ub = _mm_unpackhi_epi16(t[0], t[1]);  // lanes +4..7, rows0-3
    __m128i uc = _mm_unpacklo_epi16(t[2], t[3]);  // lanes +0..3, rows4-7
    __m128i ud = _mm_unpackhi_epi16(t[2], t[3]);  // lanes +4..7, rows4-7
    __m128i v0 = _mm_unpacklo_epi32(ua, uc);      // lanes +0,+1 full
    __m128i v1 = _mm_unpackhi_epi32(ua, uc);      // lanes +2,+3
    __m128i v2 = _mm_unpacklo_epi32(ub, ud);      // lanes +4,+5
    __m128i v3 = _mm_unpackhi_epi32(ub, ud);      // lanes +6,+7
    uint8_t* const* rr = rows + 8 * half;
    _mm_storel_epi64((__m128i*)rr[0], v0);
    _mm_storel_epi64((__m128i*)rr[1], _mm_srli_si128(v0, 8));
    _mm_storel_epi64((__m128i*)rr[2], v1);
    _mm_storel_epi64((__m128i*)rr[3], _mm_srli_si128(v1, 8));
    _mm_storel_epi64((__m128i*)rr[4], v2);
    _mm_storel_epi64((__m128i*)rr[5], _mm_srli_si128(v2, 8));
    _mm_storel_epi64((__m128i*)rr[6], v3);
    _mm_storel_epi64((__m128i*)rr[7], _mm_srli_si128(v3, 8));
  }
}
#endif  // __SSE2__

#if defined(__AVX2__)
// 16 filter lanes as one 16x int16 vector (exact same arithmetic as the
// portable loop below; all intermediates fit in int16).
static inline __m256i lf_load(const uint8_t* p) {
  return _mm256_cvtepu8_epi16(_mm_loadu_si128((const __m128i*)p));
}
static inline void lf_store(uint8_t* p, __m256i x) {
  __m128i lo = _mm256_castsi256_si128(x);
  __m128i hi = _mm256_extracti128_si256(x, 1);
  _mm_storeu_si128((__m128i*)p, _mm_packus_epi16(lo, hi));
}
static inline __m256i lf_sclip1(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(127)),
                          _mm256_set1_epi16(-128));
}
static inline __m256i lf_sclip2(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(15)),
                          _mm256_set1_epi16(-16));
}
static inline __m256i lf_clip255(__m256i x) {
  return _mm256_max_epi16(_mm256_min_epi16(x, _mm256_set1_epi16(255)),
                          _mm256_setzero_si256());
}
static inline __m256i lf_ad(__m256i a, __m256i b) {  // |a-b| (epi16)
  return _mm256_abs_epi16(_mm256_sub_epi16(a, b));
}
static inline __m256i lf_le(__m256i a, __m256i b) {  // a <= b (epi16 mask)
  return _mm256_cmpeq_epi16(_mm256_cmpgt_epi16(a, b),
                            _mm256_setzero_si256());
}
// Shared mask + f2 computation: nf (needs_filter2), hv (high edge
// variance), and the 2-tap filter outputs applied to p0/q0 under hev.
struct LfCommon {
  __m256i nf, hv, a2c, f2p0, f2q0;
};
static inline LfCommon lf_common(__m256i p3, __m256i p2, __m256i p1,
                                 __m256i p0, __m256i q0, __m256i q1,
                                 __m256i q2, __m256i q3, int thresh2,
                                 int it, int hev_t) {
  LfCommon c;
  const __m256i vit = _mm256_set1_epi16((short)it);
  __m256i sum = _mm256_add_epi16(
      _mm256_slli_epi16(lf_ad(p0, q0), 2), lf_ad(p1, q1));
  c.nf = lf_le(sum, _mm256_set1_epi16((short)thresh2));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p3, p2), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p2, p1), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(p1, p0), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q3, q2), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q2, q1), vit));
  c.nf = _mm256_and_si256(c.nf, lf_le(lf_ad(q1, q0), vit));
  const __m256i vhev = _mm256_set1_epi16((short)hev_t);
  c.hv = _mm256_or_si256(_mm256_cmpgt_epi16(lf_ad(p1, p0), vhev),
                         _mm256_cmpgt_epi16(lf_ad(q1, q0), vhev));
  __m256i d = _mm256_sub_epi16(q0, p0);
  c.a2c = _mm256_add_epi16(
      _mm256_add_epi16(d, _mm256_add_epi16(d, d)),
      lf_sclip1(_mm256_sub_epi16(p1, q1)));
  __m256i f2a1 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(c.a2c, _mm256_set1_epi16(4)), 3));
  __m256i f2a2 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(c.a2c, _mm256_set1_epi16(3)), 3));
  c.f2p0 = lf_clip255(_mm256_add_epi16(p0, f2a2));
  c.f2q0 = lf_clip255(_mm256_sub_epi16(q0, f2a1));
  return c;
}
static inline __m256i lf_sel(__m256i nf, __m256i hv, __m256i orig,
                             __m256i on_hev, __m256i on_nohev) {
  __m256i inner = _mm256_blendv_epi8(on_nohev, on_hev, hv);
  return _mm256_blendv_epi8(orig, inner, nf);
}
#endif  // __AVX2__

static void lane_core26(EdgeBuf b, int thresh2, int it, int hev_t) {
#if defined(__AVX2__)
  __m256i p3 = lf_load(b[0]), p2 = lf_load(b[1]), p1 = lf_load(b[2]),
          p0 = lf_load(b[3]), q0 = lf_load(b[4]), q1 = lf_load(b[5]),
          q2 = lf_load(b[6]), q3 = lf_load(b[7]);
  LfCommon c = lf_common(p3, p2, p1, p0, q0, q1, q2, q3, thresh2, it, hev_t);
  __m256i a6 = lf_sclip1(c.a2c);
  const __m256i v63 = _mm256_set1_epi16(63);
  __m256i b1 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(27)), v63), 7);
  __m256i b2 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(18)), v63), 7);
  __m256i b3 = _mm256_srai_epi16(
      _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16(9)), v63), 7);
  lf_store(b[1], lf_sel(c.nf, c.hv, p2, p2,
                        lf_clip255(_mm256_add_epi16(p2, b3))));
  lf_store(b[2], lf_sel(c.nf, c.hv, p1, p1,
                        lf_clip255(_mm256_add_epi16(p1, b2))));
  lf_store(b[3], lf_sel(c.nf, c.hv, p0, c.f2p0,
                        lf_clip255(_mm256_add_epi16(p0, b1))));
  lf_store(b[4], lf_sel(c.nf, c.hv, q0, c.f2q0,
                        lf_clip255(_mm256_sub_epi16(q0, b1))));
  lf_store(b[5], lf_sel(c.nf, c.hv, q1, q1,
                        lf_clip255(_mm256_sub_epi16(q1, b2))));
  lf_store(b[6], lf_sel(c.nf, c.hv, q2, q2,
                        lf_clip255(_mm256_sub_epi16(q2, b3))));
#else
  for (int j = 0; j < 16; j++) {
    int p3 = b[0][j], p2 = b[1][j], p1 = b[2][j], p0 = b[3][j];
    int q0 = b[4][j], q1 = b[5][j], q2 = b[6][j], q3 = b[7][j];
    int nf = (4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2) &
             (iabs(p3 - p2) <= it) & (iabs(p2 - p1) <= it) &
             (iabs(p1 - p0) <= it) & (iabs(q3 - q2) <= it) &
             (iabs(q2 - q1) <= it) & (iabs(q1 - q0) <= it);
    int hv = (iabs(p1 - p0) > hev_t) | (iabs(q1 - q0) > hev_t);
    int a2c = 3 * (q0 - p0) + sclip1(p1 - q1);
    int f2a1 = sclip2((a2c + 4) >> 3);
    int f2a2 = sclip2((a2c + 3) >> 3);
    int f2p0 = clip255i(p0 + f2a2), f2q0 = clip255i(q0 - f2a1);
    int a6 = sclip1(a2c);
    int b1 = (27 * a6 + 63) >> 7;
    int b2 = (18 * a6 + 63) >> 7;
    int b3 = (9 * a6 + 63) >> 7;
    int f6p2 = clip255i(p2 + b3), f6p1 = clip255i(p1 + b2);
    int f6p0 = clip255i(p0 + b1), f6q0 = clip255i(q0 - b1);
    int f6q1 = clip255i(q1 - b2), f6q2 = clip255i(q2 - b3);
    b[1][j] = (uint8_t)(nf ? (hv ? p2 : f6p2) : p2);
    b[2][j] = (uint8_t)(nf ? (hv ? p1 : f6p1) : p1);
    b[3][j] = (uint8_t)(nf ? (hv ? f2p0 : f6p0) : p0);
    b[4][j] = (uint8_t)(nf ? (hv ? f2q0 : f6q0) : q0);
    b[5][j] = (uint8_t)(nf ? (hv ? q1 : f6q1) : q1);
    b[6][j] = (uint8_t)(nf ? (hv ? q2 : f6q2) : q2);
  }
#endif
}
static void lane_core24(EdgeBuf b, int thresh2, int it, int hev_t) {
#if defined(__AVX2__)
  __m256i p3 = lf_load(b[0]), p2 = lf_load(b[1]), p1 = lf_load(b[2]),
          p0 = lf_load(b[3]), q0 = lf_load(b[4]), q1 = lf_load(b[5]),
          q2 = lf_load(b[6]), q3 = lf_load(b[7]);
  LfCommon c = lf_common(p3, p2, p1, p0, q0, q1, q2, q3, thresh2, it, hev_t);
  __m256i d = _mm256_sub_epi16(q0, p0);
  __m256i a4 = _mm256_add_epi16(d, _mm256_add_epi16(d, d));
  __m256i f4a1 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(a4, _mm256_set1_epi16(4)), 3));
  __m256i f4a2 = lf_sclip2(_mm256_srai_epi16(
      _mm256_add_epi16(a4, _mm256_set1_epi16(3)), 3));
  __m256i f4a3 = _mm256_srai_epi16(
      _mm256_add_epi16(f4a1, _mm256_set1_epi16(1)), 1);
  lf_store(b[2], lf_sel(c.nf, c.hv, p1, p1,
                        lf_clip255(_mm256_add_epi16(p1, f4a3))));
  lf_store(b[3], lf_sel(c.nf, c.hv, p0, c.f2p0,
                        lf_clip255(_mm256_add_epi16(p0, f4a2))));
  lf_store(b[4], lf_sel(c.nf, c.hv, q0, c.f2q0,
                        lf_clip255(_mm256_sub_epi16(q0, f4a1))));
  lf_store(b[5], lf_sel(c.nf, c.hv, q1, q1,
                        lf_clip255(_mm256_sub_epi16(q1, f4a3))));
#else
  for (int j = 0; j < 16; j++) {
    int p3 = b[0][j], p2 = b[1][j], p1 = b[2][j], p0 = b[3][j];
    int q0 = b[4][j], q1 = b[5][j], q2 = b[6][j], q3 = b[7][j];
    int nf = (4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2) &
             (iabs(p3 - p2) <= it) & (iabs(p2 - p1) <= it) &
             (iabs(p1 - p0) <= it) & (iabs(q3 - q2) <= it) &
             (iabs(q2 - q1) <= it) & (iabs(q1 - q0) <= it);
    int hv = (iabs(p1 - p0) > hev_t) | (iabs(q1 - q0) > hev_t);
    int a2c = 3 * (q0 - p0) + sclip1(p1 - q1);
    int f2a1 = sclip2((a2c + 4) >> 3);
    int f2a2 = sclip2((a2c + 3) >> 3);
    int f2p0 = clip255i(p0 + f2a2), f2q0 = clip255i(q0 - f2a1);
    int a4 = 3 * (q0 - p0);
    int f4a1 = sclip2((a4 + 4) >> 3);
    int f4a2 = sclip2((a4 + 3) >> 3);
    int f4a3 = (f4a1 + 1) >> 1;
    int f4p1 = clip255i(p1 + f4a3), f4p0 = clip255i(p0 + f4a2);
    int f4q0 = clip255i(q0 - f4a1), f4q1 = clip255i(q1 - f4a3);
    b[2][j] = (uint8_t)(nf ? (hv ? p1 : f4p1) : p1);
    b[3][j] = (uint8_t)(nf ? (hv ? f2p0 : f4p0) : p0);
    b[4][j] = (uint8_t)(nf ? (hv ? f2q0 : f4q0) : q0);
    b[5][j] = (uint8_t)(nf ? (hv ? q1 : f4q1) : q1);
  }
#endif
}

// Luma edge (16 lanes).  For vertical edges (hstride == 1) the lanes'
// across-edge pixels are contiguous: SIMD-transpose in and out.
static void filter_loop26(uint8_t* p, int hstride, int vstride, int n,
                          int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1 && n == 16) {
    uint8_t* rows[16];
    for (int j = 0; j < 16; j++)
      rows[j] = p + (std::ptrdiff_t)j * vstride - 4;
    tr_gather(rows, b);
    lane_core26(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(p, hstride, vstride, n, 0, b);
  if (n < 16)  // lone chroma edge (fallback callers): mirror into top lanes
    edge_gather(p, hstride, vstride, n, 16 - n, b);
  lane_core26(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(p, hstride, vstride, n, 0, b, 1, 6);
}
static void filter_loop24(uint8_t* p, int hstride, int vstride, int n,
                          int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1 && n == 16) {
    uint8_t* rows[16];
    for (int j = 0; j < 16; j++)
      rows[j] = p + (std::ptrdiff_t)j * vstride - 4;
    tr_gather(rows, b);
    lane_core24(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(p, hstride, vstride, n, 0, b);
  if (n < 16)
    edge_gather(p, hstride, vstride, n, 16 - n, b);
  lane_core24(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(p, hstride, vstride, n, 0, b, 2, 5);
}
// Paired chroma edge: U lanes 0-7, V lanes 8-15, one core call.
static void filter_loop26_uv(uint8_t* up, uint8_t* vp, int hstride,
                             int vstride, int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1) {
    uint8_t* rows[16];
    for (int j = 0; j < 8; j++) {
      rows[j] = up + (std::ptrdiff_t)j * vstride - 4;
      rows[8 + j] = vp + (std::ptrdiff_t)j * vstride - 4;
    }
    tr_gather(rows, b);
    lane_core26(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(up, hstride, vstride, 8, 0, b);
  edge_gather(vp, hstride, vstride, 8, 8, b);
  lane_core26(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(up, hstride, vstride, 8, 0, b, 1, 6);
  edge_scatter(vp, hstride, vstride, 8, 8, b, 1, 6);
}
static void filter_loop24_uv(uint8_t* up, uint8_t* vp, int hstride,
                             int vstride, int thresh, int it, int hev_t) {
  EdgeBuf b;
#if defined(__SSE2__)
  if (hstride == 1) {
    uint8_t* rows[16];
    for (int j = 0; j < 8; j++) {
      rows[j] = up + (std::ptrdiff_t)j * vstride - 4;
      rows[8 + j] = vp + (std::ptrdiff_t)j * vstride - 4;
    }
    tr_gather(rows, b);
    lane_core24(b, 2 * thresh + 1, it, hev_t);
    tr_scatter(b, rows);
    return;
  }
#endif
  edge_gather(up, hstride, vstride, 8, 0, b);
  edge_gather(vp, hstride, vstride, 8, 8, b);
  lane_core24(b, 2 * thresh + 1, it, hev_t);
  edge_scatter(up, hstride, vstride, 8, 0, b, 2, 5);
  edge_scatter(vp, hstride, vstride, 8, 8, b, 2, 5);
}
static void filter_simple(uint8_t* p, int hstride, int vstride, int n,
                          int thresh) {
  int thresh2 = 2 * thresh + 1;
  uint8_t lanes[4][16];
  for (int r = 0; r < 4; r++) {
    const uint8_t* src = p + (std::ptrdiff_t)(r - 2) * hstride;
    for (int j = 0; j < n; j++) lanes[r][j] = src[(std::ptrdiff_t)j * vstride];
  }
  for (int j = 0; j < 16; j++) {
    int p1 = lanes[0][j], p0 = lanes[1][j], q0 = lanes[2][j], q1 = lanes[3][j];
    int nf = 4 * iabs(p0 - q0) + iabs(p1 - q1) <= thresh2;
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3);
    int a2 = sclip2((a + 3) >> 3);
    int fp0 = clip255i(p0 + a2), fq0 = clip255i(q0 - a1);
    lanes[1][j] = (uint8_t)(nf ? fp0 : p0);
    lanes[2][j] = (uint8_t)(nf ? fq0 : q0);
  }
  for (int r = 1; r < 3; r++) {
    uint8_t* dst = p + (std::ptrdiff_t)(r - 2) * hstride;
    for (int j = 0; j < n; j++) dst[(std::ptrdiff_t)j * vstride] = lanes[r][j];
  }
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

// Reconstruction of MB rows [row0, row1) from a parsed MB list.
// Context comes straight from the output planes: the row above is
// reconstructed and still unfiltered (the filter runs after the
// whole frame).
static void recon_rows(
    std::vector<MB>& mbs, int mb_w, int row0, int row1,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int ys = mb_w * 16;          // luma stride
  const int cs = mb_w * 8;           // chroma stride
  std::vector<uint8_t> ybuf(17 * BUFS), ubuf(9 * BUFS), vbuf(9 * BUFS);
  for (int mb_y = row0; mb_y < row1; mb_y++) {
    for (int mb_x = 0; mb_x < mb_w; mb_x++) {
      MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
      bool ht = mb_y > 0, hl = mb_x > 0;
      // Fill borders.
      if (ht) {
        const uint8_t* yt = y_out + (size_t)(mb_y * 16 - 1) * ys + mb_x * 16;
        std::memcpy(&ybuf[1], yt, 16);
        if (mb_x < mb_w - 1) std::memcpy(&ybuf[17], yt + 16, 4);
        else std::memset(&ybuf[17], yt[15], 4);
        const uint8_t* ut = u_out + (size_t)(mb_y * 8 - 1) * cs + mb_x * 8;
        const uint8_t* vt = v_out + (size_t)(mb_y * 8 - 1) * cs + mb_x * 8;
        std::memcpy(&ubuf[1], ut, 8);
        std::memcpy(&vbuf[1], vt, 8);
        ybuf[0] = hl ? yt[-1] : 129;
        ubuf[0] = hl ? ut[-1] : 129;
        vbuf[0] = hl ? vt[-1] : 129;
      } else {
        std::memset(&ybuf[0], 127, 21);
        std::memset(&ubuf[0], 127, 9);
        std::memset(&vbuf[0], 127, 9);
      }
      for (int r = 0; r < 16; r++)
        ybuf[(1 + r) * BUFS] = hl
            ? y_out[(size_t)(mb_y * 16 + r) * ys + mb_x * 16 - 1] : 129;
      for (int r = 0; r < 8; r++) {
        ubuf[(1 + r) * BUFS] = hl
            ? u_out[(size_t)(mb_y * 8 + r) * cs + mb_x * 8 - 1] : 129;
        vbuf[(1 + r) * BUFS] = hl
            ? v_out[(size_t)(mb_y * 8 + r) * cs + mb_x * 8 - 1] : 129;
      }
      if (mb.is_i4) {
        // Replicate TR below row 0 for right-column blocks.
        for (int rr = 4; rr <= 12; rr += 4)
          std::memcpy(&ybuf[rr * BUFS + 17], &ybuf[17], 4);
        for (int n = 0; n < 16; n++) {
          int r = 4 * (n >> 2), c = 4 * (n & 3);
          predict_luma4(ybuf.data(), c, r, mb.imodes[n]);
          if (mb.has_nz[n])
            idct_add(mb.coeffs[n], &ybuf[(r + 1) * BUFS + c + 1], BUFS);
        }
      } else {
        predict_block(ybuf.data(), 0, 0, 16, mb.ymode, ht, hl);
        for (int n = 0; n < 16; n++) {
          int r = 4 * (n >> 2), c = 4 * (n & 3);
          if (mb.has_nz[n])
            idct_add(mb.coeffs[n], &ybuf[(r + 1) * BUFS + c + 1], BUFS);
        }
      }
      predict_block(ubuf.data(), 0, 0, 8, mb.uvmode, ht, hl);
      predict_block(vbuf.data(), 0, 0, 8, mb.uvmode, ht, hl);
      for (int n = 0; n < 4; n++) {
        int r = 4 * (n >> 1), c = 4 * (n & 1);
        if (mb.has_nz[16 + n])
          idct_add(mb.coeffs[16 + n], &ubuf[(r + 1) * BUFS + c + 1], BUFS);
        if (mb.has_nz[20 + n])
          idct_add(mb.coeffs[20 + n], &vbuf[(r + 1) * BUFS + c + 1], BUFS);
      }
      // Store.
      for (int r = 0; r < 16; r++)
        std::memcpy(y_out + (size_t)(mb_y * 16 + r) * ys + mb_x * 16,
                    &ybuf[(1 + r) * BUFS + 1], 16);
      for (int r = 0; r < 8; r++) {
        std::memcpy(u_out + (size_t)(mb_y * 8 + r) * cs + mb_x * 8,
                    &ubuf[(1 + r) * BUFS + 1], 8);
        std::memcpy(v_out + (size_t)(mb_y * 8 + r) * cs + mb_x * 8,
                    &vbuf[(1 + r) * BUFS + 1], 8);
      }
    }
  }
}

// Loop filter for MB rows [row0, row1), once they and the row below are
// reconstructed: a row's column edges modify its bottom row, which the
// next row's intra prediction reads unfiltered.
static void filter_rows(
    std::vector<MB>& mbs, int mb_w, int row0, int row1,
    int filter_type, const int32_t* finfo,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const int ys = mb_w * 16;
  const int cs = mb_w * 8;
  if (filter_type > 0) {
    for (int mb_y = row0; mb_y < row1; mb_y++) {
      for (int mb_x = 0; mb_x < mb_w; mb_x++) {
        MB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
        const int32_t* fi = finfo + (mb.segment * 2 + (mb.is_i4 ? 1 : 0)) * 3;
        int limit = fi[0], il = fi[1], hv = fi[2];
        if (limit < 0) continue;
        bool inner = mb.is_i4 || !mb.skip;
        uint8_t* yp = y_out + (size_t)mb_y * 16 * ys + mb_x * 16;
        if (filter_type == 1) {
          if (mb_x > 0) filter_simple(yp, 1, ys, 16, limit + 4);
          if (inner)
            for (int dx = 4; dx <= 12; dx += 4)
              filter_simple(yp + dx, 1, ys, 16, limit);
          if (mb_y > 0) filter_simple(yp, ys, 1, 16, limit + 4);
          if (inner)
            for (int dy = 4; dy <= 12; dy += 4)
              filter_simple(yp + (size_t)dy * ys, ys, 1, 16, limit);
        } else {
          uint8_t* up = u_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          uint8_t* vp = v_out + (size_t)mb_y * 8 * cs + mb_x * 8;
          if (mb_x > 0) {
            filter_loop26(yp, 1, ys, 16, limit + 4, il, hv);
            filter_loop26_uv(up, vp, 1, cs, limit + 4, il, hv);
          }
          if (inner) {
            for (int dx = 4; dx <= 12; dx += 4)
              filter_loop24(yp + dx, 1, ys, 16, limit, il, hv);
            filter_loop24_uv(up + 4, vp + 4, 1, cs, limit, il, hv);
          }
          if (mb_y > 0) {
            filter_loop26(yp, ys, 1, 16, limit + 4, il, hv);
            filter_loop26_uv(up, vp, cs, 1, limit + 4, il, hv);
          }
          if (inner) {
            for (int dy = 4; dy <= 12; dy += 4)
              filter_loop24(yp + (size_t)dy * ys, ys, 1, 16, limit, il, hv);
            filter_loop24_uv(up + (size_t)4 * cs, vp + (size_t)4 * cs,
                             cs, 1, limit, il, hv);
          }
        }
      }
    }
  }

}


// Reconstruct host planes from the symbol engines' output arrays
// (decoder.py decode_vp8_symbols_batch): coeffs (N,24,16) dequantized
// int16, modes (N,21) = [is_i4, uvmode, segment, skip, dither,
// imodes[16]]; finfo [4][2][3] limit/ilevel/hev per (segment, is_i4),
// limit < 0 = off.  Writes the MB-padded planes.
void wtpu_vp8_recon_frame_arrays(
    const int16_t* coeffs, const uint8_t* modes,
    int mb_w, int mb_h, int filter_type, const int32_t* finfo,
    uint8_t* y_out, uint8_t* u_out, uint8_t* v_out) {
  const size_t n = (size_t)mb_w * mb_h;
  std::vector<MB> mbs(n);
  for (size_t i = 0; i < n; i++) {
    MB& mb = mbs[i];
    const uint8_t* m = modes + i * 21;
    mb.is_i4 = m[0]; mb.uvmode = m[1]; mb.segment = m[2];
    mb.skip = m[3]; mb.dither = m[4];
    std::memcpy(mb.imodes, m + 5, 16);
    mb.ymode = mb.imodes[0];
    const int16_t* c = coeffs + i * 24 * 16;
    std::memcpy(mb.coeffs, c, 24 * 16 * sizeof(int16_t));
    for (int b = 0; b < 24; b++) {
      const int16_t* q = c + b * 16;
      int16_t any = 0;
      for (int k = 0; k < 16; k++) any |= q[k];
      mb.has_nz[b] = (uint8_t)(any != 0);
    }
  }
  recon_rows(mbs, mb_w, 0, mb_h, y_out, u_out, v_out);
  filter_rows(mbs, mb_w, 0, mb_h, filter_type, finfo, y_out, u_out, v_out);
}

// ----------------------------------------------------------------------
// Fused fancy upsample + BT.601 YUV→RGBA (libwebp's EmitFancyRGB math).
// ----------------------------------------------------------------------
static inline void yuv2rgba_px(int y, int u, int v, uint8_t* o) {
  const int yy = (y * 19077) >> 8;
  int r = yy + ((v * 26149) >> 8) - 14234;
  int g = yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708;
  int b = yy + ((u * 33050) >> 8) - 17685;
  const int M = (256 << 6) - 1;
  r = r < 0 ? 0 : (r > M ? M : r);
  g = g < 0 ? 0 : (g > M ? M : g);
  b = b < 0 ? 0 : (b > M ? M : b);
  o[0] = (uint8_t)(r >> 6);
  o[1] = (uint8_t)(g >> 6);
  o[2] = (uint8_t)(b >> 6);
  o[3] = 255;
}

// One interpolated chroma row pair: T = chroma row k, B = row k+1.
// Note 2*i < width always holds for 1 <= i < w2 (w2 = ceil(width/2)),
// so the pairwise writes are unconditional and the loop is
// lane-parallel over i; an AVX2 path computes 16 i's per step.
static void fancy_row(const uint8_t* T, const uint8_t* B, int w2, int width,
                      uint8_t* out_top /* len width */, bool is_top) {
  // is_top: produce the "top" output row of the pair, else the bottom.
  if (is_top) out_top[0] = (uint8_t)((3 * T[0] + B[0] + 2) >> 2);
  else out_top[0] = (uint8_t)((3 * B[0] + T[0] + 2) >> 2);
  int i = 1;
#if defined(__AVX2__)
  for (; i + 16 <= w2; i += 16) {
    const __m256i tl = lf_load(T + i - 1), t = lf_load(T + i);
    const __m256i l = lf_load(B + i - 1), c = lf_load(B + i);
    const __m256i avg = _mm256_add_epi16(
        _mm256_add_epi16(_mm256_add_epi16(tl, t), _mm256_add_epi16(l, c)),
        _mm256_set1_epi16(8));
    const __m256i d12 = _mm256_srai_epi16(
        _mm256_add_epi16(avg, _mm256_slli_epi16(_mm256_add_epi16(t, l), 1)),
        3);
    const __m256i d03 = _mm256_srai_epi16(
        _mm256_add_epi16(avg, _mm256_slli_epi16(_mm256_add_epi16(tl, c), 1)),
        3);
    __m256i odd, evn;  // out[2i-1], out[2i]
    if (is_top) {
      odd = _mm256_srai_epi16(_mm256_add_epi16(d12, tl), 1);
      evn = _mm256_srai_epi16(_mm256_add_epi16(d03, t), 1);
    } else {
      odd = _mm256_srai_epi16(_mm256_add_epi16(d03, l), 1);
      evn = _mm256_srai_epi16(_mm256_add_epi16(d12, c), 1);
    }
    const __m128i o8 = _mm_packus_epi16(_mm256_castsi256_si128(odd),
                                        _mm256_extracti128_si256(odd, 1));
    const __m128i e8 = _mm_packus_epi16(_mm256_castsi256_si128(evn),
                                        _mm256_extracti128_si256(evn, 1));
    _mm_storeu_si128((__m128i*)(out_top + 2 * i - 1),
                     _mm_unpacklo_epi8(o8, e8));
    _mm_storeu_si128((__m128i*)(out_top + 2 * i + 15),
                     _mm_unpackhi_epi8(o8, e8));
  }
#endif
  for (; i < w2; i++) {
    const int tl = T[i - 1], t = T[i], l = B[i - 1], c = B[i];
    const int avg = tl + t + l + c + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3;
    const int d03 = (avg + 2 * (tl + c)) >> 3;
    if (is_top) {
      out_top[2 * i - 1] = (uint8_t)((d12 + tl) >> 1);
      if (2 * i < width) out_top[2 * i] = (uint8_t)((d03 + t) >> 1);
    } else {
      out_top[2 * i - 1] = (uint8_t)((d03 + l) >> 1);
      if (2 * i < width) out_top[2 * i] = (uint8_t)((d12 + c) >> 1);
    }
  }
  if (width % 2 == 0 && width > 1) {
    if (is_top)
      out_top[width - 1] = (uint8_t)((3 * T[w2 - 1] + B[w2 - 1] + 2) >> 2);
    else
      out_top[width - 1] = (uint8_t)((3 * B[w2 - 1] + T[w2 - 1] + 2) >> 2);
  }
}

#if defined(__AVX2__)
// 16 pixels of BT.601 YUV→RGBA per step, exact same fixed-point math as
// yuv2rgba_px: (x*k)>>8 == mulhi_epu16(x<<8, k); the one sum that can
// exceed int16 (yy + ub) saturates at 32767 which the >>6 clamp to
// 16383 makes exact.
static void yuv2rgba_row_avx2(const uint8_t* y, const uint8_t* u,
                              const uint8_t* v, int width, uint8_t* o) {
  const __m256i k19077 = _mm256_set1_epi16(19077);
  const __m256i k26149 = _mm256_set1_epi16((short)26149);
  const __m256i k6419 = _mm256_set1_epi16(6419);
  const __m256i k13320 = _mm256_set1_epi16(13320);
  const __m256i k33050 = _mm256_set1_epi16((short)33050);
  const __m256i c14234 = _mm256_set1_epi16(14234);
  const __m256i c8708 = _mm256_set1_epi16(8708);
  const __m256i c17685 = _mm256_set1_epi16(17685);
  const __m256i vmax = _mm256_set1_epi16((256 << 6) - 1);
  const __m256i zero = _mm256_setzero_si256();
  const __m128i a8 = _mm_set1_epi8((char)255);
  int x = 0;
  for (; x + 16 <= width; x += 16) {
    const __m256i y8 = _mm256_slli_epi16(lf_load(y + x), 8);
    const __m256i u8v = _mm256_slli_epi16(lf_load(u + x), 8);
    const __m256i v8v = _mm256_slli_epi16(lf_load(v + x), 8);
    const __m256i yy = _mm256_mulhi_epu16(y8, k19077);
    __m256i rr = _mm256_adds_epi16(
        yy, _mm256_sub_epi16(_mm256_mulhi_epu16(v8v, k26149), c14234));
    __m256i gg = _mm256_sub_epi16(
        _mm256_sub_epi16(_mm256_add_epi16(yy, c8708),
                         _mm256_mulhi_epu16(u8v, k6419)),
        _mm256_mulhi_epu16(v8v, k13320));
    __m256i bb = _mm256_adds_epi16(
        yy, _mm256_sub_epi16(_mm256_mulhi_epu16(u8v, k33050), c17685));
    rr = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(rr, vmax), zero), 6);
    gg = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(gg, vmax), zero), 6);
    bb = _mm256_srai_epi16(_mm256_max_epi16(_mm256_min_epi16(bb, vmax), zero), 6);
    const __m128i r8 = _mm_packus_epi16(_mm256_castsi256_si128(rr),
                                        _mm256_extracti128_si256(rr, 1));
    const __m128i g8 = _mm_packus_epi16(_mm256_castsi256_si128(gg),
                                        _mm256_extracti128_si256(gg, 1));
    const __m128i b8 = _mm_packus_epi16(_mm256_castsi256_si128(bb),
                                        _mm256_extracti128_si256(bb, 1));
    const __m128i rg0 = _mm_unpacklo_epi8(r8, g8);
    const __m128i rg1 = _mm_unpackhi_epi8(r8, g8);
    const __m128i ba0 = _mm_unpacklo_epi8(b8, a8);
    const __m128i ba1 = _mm_unpackhi_epi8(b8, a8);
    uint8_t* op = o + 4 * (size_t)x;
    _mm_storeu_si128((__m128i*)(op + 0), _mm_unpacklo_epi16(rg0, ba0));
    _mm_storeu_si128((__m128i*)(op + 16), _mm_unpackhi_epi16(rg0, ba0));
    _mm_storeu_si128((__m128i*)(op + 32), _mm_unpacklo_epi16(rg1, ba1));
    _mm_storeu_si128((__m128i*)(op + 48), _mm_unpackhi_epi16(rg1, ba1));
  }
  for (; x < width; x++) yuv2rgba_px(y[x], u[x], v[x], o + 4 * (size_t)x);
}
#endif  // __AVX2__

void wtpu_yuv_to_rgba_fancy(const uint8_t* yp, const uint8_t* up,
                            const uint8_t* vp, int width, int height,
                            int y_stride, int uv_stride, uint8_t* out) {
  const int w2 = (width + 1) >> 1;
  const int h2 = (height + 1) >> 1;
  std::vector<uint8_t> urow(width), vrow(width);

  auto emit_row = [&](int r) {
    const uint8_t* y = yp + (int64_t)r * y_stride;
    uint8_t* o = out + (int64_t)r * width * 4;
#if defined(__AVX2__)
    yuv2rgba_row_avx2(y, urow.data(), vrow.data(), width, o);
#else
    for (int x = 0; x < width; x++)
      yuv2rgba_px(y[x], urow[x], vrow[x], o + 4 * x);
#endif
  };

  // Row 0: self-pair of chroma row 0.
  fancy_row(up, up, w2, width, urow.data(), true);
  fancy_row(vp, vp, w2, width, vrow.data(), true);
  emit_row(0);
  for (int k = 0; k + 1 < h2; k++) {
    const uint8_t* uT = up + (int64_t)k * uv_stride;
    const uint8_t* uB = uT + uv_stride;
    const uint8_t* vT = vp + (int64_t)k * uv_stride;
    const uint8_t* vB = vT + uv_stride;
    if (2 * k + 1 < height) {
      fancy_row(uT, uB, w2, width, urow.data(), true);
      fancy_row(vT, vB, w2, width, vrow.data(), true);
      emit_row(2 * k + 1);
    }
    if (2 * k + 2 < height) {
      fancy_row(uT, uB, w2, width, urow.data(), false);
      fancy_row(vT, vB, w2, width, vrow.data(), false);
      emit_row(2 * k + 2);
    }
  }
  if (height % 2 == 0 && height > 1) {
    const uint8_t* uL = up + (int64_t)(h2 - 1) * uv_stride;
    const uint8_t* vL = vp + (int64_t)(h2 - 1) * uv_stride;
    fancy_row(uL, uL, w2, width, urow.data(), true);
    fancy_row(vL, vL, w2, width, vrow.data(), true);
    emit_row(height - 1);
  }
}

}  // extern "C"

// ----------------------------------------------------------------------
// Sparse coefficient-upload pack (ops/coeff_pack.py).  Re-compresses the
// symbol engines' dequantized (N, 24, 16) int16 coefficients of a group
// of B images into int8 zigzag levels (the first K a block), the i16 MBs'
// luma DC side plane, a tail table (the levels past K of the blocks that
// have them) and a raw exception table (blocks whose levels do not fit
// int8 or do not divide by their quantizer), in two passes:
//
// - wtpu_vp8_pack_scan reads each dense block once.  A level is the
//   coefficient times the float reciprocal of its quantizer, rounded:
//   |v| < 2^15, so the product is within 2^-8 of v / q and rounds to it
//   wherever q divides v; multiplying back checks it.  No integer
//   division.  It writes the wire layout of K = 4: each block's first 4
//   levels, the tail rows of the blocks whose non-zeros reach past 4 (in
//   block order: the index and levels 4-15) and the exception blocks'
//   indices, and counts what the K chooser needs.
// - wtpu_vp8_pack_emit, once K is chosen, writes the exception rows (the
//   raw zigzag row, re-read from the dense array for those blocks only)
//   and, at K = 8 or 16, lv8 and the tail table from the K = 4 layout.
//
// The AVX-512 path handles a block in one 32-byte load and a few vector
// instructions; the scalar path gives the same bytes.  Equal to
// ops/coeff_pack.py's numpy pack_coeffs_plain (tests).
// ----------------------------------------------------------------------

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
#define WTPU_PACK_AVX512 1
#endif

namespace {
static const int kPackZZ[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};

// One segment's quantizers by lane: [0] luma, [1] chroma; lane 0 the DC
// quantizer, lanes 1-15 the AC one.
struct PackQuant {
  alignas(64) int32_t q[2][16];
  alignas(64) float r[2][16];
};

static void pack_quants(const int32_t* qm /* [4][6] */, PackQuant* pq) {
  for (int s = 0; s < 4; s++) {
    for (int uv = 0; uv < 2; uv++) {
      for (int n = 0; n < 16; n++) {
        const int32_t q = qm[s * 6 + (uv ? 4 : 0) + (n ? 1 : 0)];
        pq[s].q[uv][n] = q;
        pq[s].r[uv][n] = 1.0f / (float)q;
      }
    }
  }
}

// A block's 16 zigzag levels → its raw eob (the last non-zero raw
// position + 1, the dropped i16 DC included; 0 for a zero block), or -1
// for an exception.
#ifdef WTPU_PACK_AVX512
static inline int pack_block(const int16_t* c, const int32_t* q,
                             const float* r, bool drop_dc, int8_t* lv) {
  const __m256i kZZ = _mm256_setr_epi16(0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13,
                                        10, 7, 11, 14, 15);
  const __m256i zz = _mm256_permutexvar_epi16(
      kZZ, _mm256_loadu_si256(reinterpret_cast<const __m256i*>(c)));
  const __mmask16 nz = _mm256_test_epi16_mask(zz, zz);
  const __mmask16 live = drop_dc ? (__mmask16)(nz & 0xFFFE) : nz;
  const __m512i v = _mm512_cvtepi16_epi32(zz);
  const __m512i l = _mm512_maskz_cvtps_epi32(
      live, _mm512_mul_ps(_mm512_cvtepi32_ps(v), _mm512_load_ps(r)));
  const __m512i back = _mm512_mullo_epi32(l, _mm512_load_si512(q));
  const __mmask16 bad =
      _mm512_mask_cmpneq_epi32_mask(live, back, v) |
      _mm512_mask_cmpgt_epu32_mask(live, _mm512_add_epi32(
          l, _mm512_set1_epi32(127)), _mm512_set1_epi32(254));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(lv), _mm512_cvtepi32_epi8(l));
  return bad ? -1 : 32 - (int)_lzcnt_u32((unsigned)nz);
}
#else
static inline int pack_block(const int16_t* c, const int32_t* q,
                             const float* r, bool drop_dc, int8_t* lv) {
  int eob = 0;
  bool ok = true;
  for (int n = 0; n < 16; n++) {
    const int32_t raw = c[kPackZZ[n]];
    if (raw != 0) eob = n + 1;
    const int32_t v = (n == 0 && drop_dc) ? 0 : raw;
    const int32_t l = v ? (int32_t)lrintf((float)v * r[n]) : 0;
    ok &= (int64_t)l * q[n] == v && l >= -127 && l <= 127;
    lv[n] = (int8_t)l;
  }
  return ok ? eob : -1;
}
#endif

static inline bool any_nonzero8(const int8_t* p) {
  uint64_t w;
  std::memcpy(&w, p, 8);
  return w != 0;
}
}  // namespace

// First pass.  coeffs[b] is image b's (N, 24, 16) array; seg, is_i4
// [B*N]; qmat [B][4][6].  Writes head [B*N*24][4] (lv8 at K = 4; zero
// for an exception), dc16 [B*N][16], the K = 4 tail table (t4_idx,
// t4_val [rows][12]) and exc_idx, each table in block order with room
// for every block.
// counts = [zero blocks, exception blocks, tails past 4, tails past 8]
// (tails exclude exceptions).
extern "C" void wtpu_vp8_pack_scan(
    const int16_t* const* coeffs, const uint8_t* seg, const uint8_t* is_i4,
    const int32_t* qmat, int B, int N, int8_t* head, int16_t* dc16,
    int32_t* t4_idx, int8_t* t4_val, int32_t* exc_idx, int64_t* counts) {
  int64_t n_zero = 0, n_exc = 0, n_t4 = 0, n_t8 = 0;
  PackQuant pq[4];
  for (int b = 0; b < B; b++) {
    pack_quants(qmat + (size_t)b * 24, pq);
    const int16_t* c = coeffs[b];
    for (int i = 0; i < N; i++) {
      const size_t mb = (size_t)b * N + i;
      const PackQuant& q = pq[seg[mb] < 4 ? seg[mb] : 0];
      const bool i16 = is_i4[mb] == 0;
      int16_t* dcrow = dc16 + mb * 16;
      for (int blk = 0; blk < 24; blk++, c += 16) {
        // Branch-free but for exceptions: every block writes its head and
        // a tail row at the table's end, which only a tail keeps.
        const size_t k = mb * 24 + blk;
        const bool luma = blk < 16;
        if (luma) dcrow[blk] = i16 ? c[0] : 0;
        const int uv = luma ? 0 : 1;
        int8_t lv[16];
        const int eob = pack_block(c, q.q[uv], q.r[uv], luma && i16, lv);
        if (eob < 0) {
          std::memset(head + k * 4, 0, 4);
          exc_idx[n_exc++] = (int32_t)k;
          continue;
        }
        std::memcpy(head + k * 4, lv, 4);
        std::memcpy(t4_val + n_t4 * 12, lv + 4, 12);
        t4_idx[n_t4] = (int32_t)k;
        n_zero += eob == 0;
        n_t4 += eob > 4;
        n_t8 += eob > 8;
      }
    }
  }
  counts[0] = n_zero;
  counts[1] = n_exc;
  counts[2] = n_t4;
  counts[3] = n_t8;
}

// Second pass, for the chosen K, from the scan's tables: exc_val [n_exc]
// [16] raw zigzag rows; at K = 8 or 16 also lv8 [B*N*24][K] and, at
// K = 8, the tail table (tail_idx, tail_val [rows][8]; the rows of the
// K = 4 table with a non-zero past position 8).  At K = 4 the scan's
// head and table are already the wire arrays.  Returns the tail rows
// written, or -1 for a K other than 4, 8 or 16 or a table larger than
// tail_cap.
extern "C" int64_t wtpu_vp8_pack_emit(
    const int16_t* const* coeffs, int B, int N, int K, const int8_t* head,
    const int32_t* t4_idx, const int8_t* t4_val, int64_t n_t4,
    const int32_t* exc_idx, int64_t n_exc, int16_t* exc_val, int8_t* lv8,
    int32_t* tail_idx, int8_t* tail_val, int64_t tail_cap) {
  if (K != 4 && K != 8 && K != 16) return -1;
  const int64_t per = (int64_t)N * 24;
  for (int64_t e = 0; e < n_exc; e++) {
    const int64_t k = exc_idx[e];
    const int16_t* c = coeffs[k / per] + (k % per) * 16;
    for (int n = 0; n < 16; n++) exc_val[e * 16 + n] = c[kPackZZ[n]];
  }
  if (K == 4) return n_t4;
  const int64_t nblocks = (int64_t)B * per;
  for (int64_t k = 0; k < nblocks; k++) {
    std::memcpy(lv8 + k * K, head + k * 4, 4);
    std::memset(lv8 + k * K + 4, 0, K - 4);
  }
  int64_t ntail = 0;
  for (int64_t r = 0; r < n_t4; r++) {
    const int64_t k = t4_idx[r];
    const int8_t* row = t4_val + r * 12;
    std::memcpy(lv8 + k * K + 4, row, K - 4);
    if (K == 8 && any_nonzero8(row + 4)) {
      if (ntail == tail_cap) return -1;
      tail_idx[ntail] = (int32_t)k;
      std::memcpy(tail_val + ntail * 8, row + 4, 8);
      ntail++;
    }
  }
  return ntail;
}
