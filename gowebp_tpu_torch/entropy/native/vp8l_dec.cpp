// VP8L (WebP lossless) hot loops, native host layer.
//
// Sequential bit-level work runs on the host: this file holds the
// prefix-code section reader (wtpu_vp8l_read_groups), the per-pixel
// Huffman/LZ77/colour-cache decode loop (wtpu_vp8l_decode_pixels) and
// the inverse transforms (add-green, cross-colour, predictor) plus the
// ARGB -> RGBA repack, and the encoder's transform analysis: the
// per-tile predictor chooser (wtpu_vp8l_choose_predictors), the forward
// predictor residual and the cross-colour fit; driven from models/vp8l/
// via ctypes with the GIL released.  Written from the lossless bitstream
// spec.
//
// Build: g++ -O3 -fPIC -shared (see native_loader.py).

#if defined(__SSE2__)
#include <immintrin.h>
#endif
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// LSB-first bit reader with a cached 64-bit window: one unaligned load
// per ~40 consumed bits instead of one per peek.  The refill invariant
// guarantees >= 20 valid window bits before any decode step (max single
// read is a 15-bit Huffman code or 19 extra bits).
// ----------------------------------------------------------------------
struct BitReader {
  const uint8_t* data;
  uint64_t size;
  uint64_t bit_pos;
  uint64_t window = 0;
  int avail = 0;

  void refill() {
    uint64_t byte_pos = bit_pos >> 3;
    uint64_t chunk = 0;
    if (byte_pos + 8 <= size) {
      std::memcpy(&chunk, data + byte_pos, 8);
    } else if (byte_pos < size) {
      std::memcpy(&chunk, data + byte_pos, size - byte_pos);
    }
    window = chunk >> (bit_pos & 7);
    avail = 64 - (int)(bit_pos & 7);
  }
  inline uint32_t peek(int n) const {
    return (uint32_t)(window & ((1ull << n) - 1));
  }
  inline void consume(int n) {
    window >>= n;
    avail -= n;
    bit_pos += n;
    if (avail < 20) refill();
  }
  inline uint32_t read(int n) {
    uint32_t v = peek(n);
    consume(n);
    return v;
  }
  inline bool overrun() const { return bit_pos > size * 8; }
};

// ----------------------------------------------------------------------
// Two-level canonical Huffman table (root 8 bits), keys are LSB-first
// reversed codes.
// ----------------------------------------------------------------------
constexpr int ROOT_BITS = 8;

struct HuffEntry {
  int16_t sym;    // symbol or subtable size marker
  uint8_t len;    // code length (root) / total length (sub)
};

struct HuffTable {
  std::vector<HuffEntry> root;     // 1 << ROOT_BITS
  std::vector<HuffEntry> sub;      // subtable pool
  std::vector<int32_t> sub_off;    // per root slot: offset into sub (or -1)
  std::vector<uint8_t> sub_bits;   // per root slot: extra bits in subtable
  int max_len = 0;
  int single = -1;                 // single-symbol code (0 bits)

  inline int decode(BitReader& br) const {
    if (single >= 0) return single;
    uint32_t key = br.peek(ROOT_BITS);
    const HuffEntry& e = root[key];
    if (e.len) {
      br.consume(e.len);
      return e.sym;
    }
    // Subtable.
    uint32_t key2 = br.peek(max_len);
    uint32_t hi = key2 >> ROOT_BITS;
    int32_t off = sub_off[key];
    const HuffEntry& s = sub[off + (hi & ((1u << sub_bits[key]) - 1))];
    br.consume(s.len);
    return s.sym;
  }
};

static uint32_t reverse_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

// Returns false on invalid code.
static bool build_table(const int32_t* lengths, int n, HuffTable* t) {
  int used = 0, single = -1, max_len = 0;
  for (int i = 0; i < n; i++) {
    if (lengths[i] > 0) { used++; single = i; if (lengths[i] > max_len) max_len = lengths[i]; }
  }
  if (used == 0) return false;
  if (used == 1) { t->single = single; return true; }
  if (max_len > 15) return false;
  // Kraft check.
  int64_t kraft = 0;
  for (int i = 0; i < n; i++)
    if (lengths[i]) kraft += 1ll << (max_len - lengths[i]);
  if (kraft != (1ll << max_len)) return false;

  // Canonical codes.
  int bl_count[16] = {0};
  for (int i = 0; i < n; i++) bl_count[lengths[i]]++;
  bl_count[0] = 0;
  uint32_t next_code[17] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= max_len; l++) {
    code = (code + bl_count[l - 1]) << 1;
    next_code[l] = code;
  }
  t->max_len = max_len;
  t->root.assign(1 << ROOT_BITS, {0, 0});
  t->sub_off.assign(1 << ROOT_BITS, -1);
  t->sub_bits.assign(1 << ROOT_BITS, 0);

  int sub_len = max_len > ROOT_BITS ? max_len - ROOT_BITS : 0;
  // First pass: mark root slots needing subtables.
  if (sub_len > 0) {
    for (int i = 0; i < n; i++) {
      int l = lengths[i];
      if (l <= ROOT_BITS || l == 0) continue;
      uint32_t c = next_code[l];  // don't consume yet
      (void)c;
    }
  }
  // Allocate subtables lazily below.
  for (int i = 0; i < n; i++) {
    int l = lengths[i];
    if (l == 0) continue;
    uint32_t c = next_code[l]++;
    uint32_t rc = reverse_bits(c, l);
    if (l <= ROOT_BITS) {
      for (uint32_t k = rc; k < (1u << ROOT_BITS); k += (1u << l)) {
        t->root[k] = {(int16_t)i, (uint8_t)l};
      }
    } else {
      uint32_t low = rc & ((1u << ROOT_BITS) - 1);
      uint32_t hi = rc >> ROOT_BITS;
      if (t->sub_off[low] < 0) {
        t->sub_off[low] = (int32_t)t->sub.size();
        t->sub_bits[low] = (uint8_t)sub_len;
        t->sub.resize(t->sub.size() + (1u << sub_len), {0, 0});
      }
      int32_t off = t->sub_off[low];
      int hi_len = l - ROOT_BITS;
      for (uint32_t k = hi; k < (1u << sub_len); k += (1u << hi_len)) {
        t->sub[off + k] = {(int16_t)i, (uint8_t)l};
      }
    }
  }
  return true;
}

// ----------------------------------------------------------------------
// Distance mapping
// ----------------------------------------------------------------------
struct DistPair { int8_t dx; int8_t dy; };
static DistPair kDistMap[120];
static bool dist_map_init = false;

static void init_dist_map() {
  if (dist_map_init) return;
  struct P { int dx, dy, d2, ax, neg; };
  std::vector<P> ps;
  for (int dy = 0; dy < 8; dy++) {
    int lo = dy == 0 ? 1 : -7;
    for (int dx = lo; dx <= 8; dx++) {
      ps.push_back({dx, dy, dx * dx + dy * dy, dx < 0 ? -dx : dx, dx < 0});
    }
  }
  for (size_t i = 0; i < ps.size(); i++)
    for (size_t j = i + 1; j < ps.size(); j++) {
      const P& a = ps[i]; const P& b = ps[j];
      bool swap = (b.d2 < a.d2) ||
                  (b.d2 == a.d2 && (b.ax < a.ax || (b.ax == a.ax && b.neg < a.neg)));
      if (swap) std::swap(ps[i], ps[j]);
    }
  for (int i = 0; i < 120; i++) kDistMap[i] = {(int8_t)ps[i].dx, (int8_t)ps[i].dy};
  dist_map_init = true;
}

static inline int plane_code_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int d = kDistMap[code - 1].dy * xsize + kDistMap[code - 1].dx;
  return d >= 1 ? d : 1;
}

static inline int prefix_decode(BitReader& br, int code) {
  if (code < 4) return code + 1;
  int extra = (code - 2) >> 1;
  int offset = (2 + (code & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

// Main symbol loop, specialized on meta-huffman / color-cache presence
// so the per-pixel branches compile away.
template <bool META, bool CACHE>
static int decode_pixels_loop(BitReader& br, int width, int height,
                              const std::vector<HuffTable>& tables,
                              int num_groups, const int32_t* huffman_image,
                              int huffman_bits, int meta_w, int cache_bits,
                              uint32_t* out_pixels) {
  const int cache_size = CACHE ? (1 << cache_bits) : 0;
  std::vector<uint32_t> cache((size_t)cache_size, 0);
  const int cache_shift = CACHE ? 32 - cache_bits : 0;
  const int cache_limit = 256 + 24;

  int64_t npix = (int64_t)width * height;
  int64_t pos = 0;
  int x = 0, y = 0;
  const HuffTable* g_green = &tables[0];
  const HuffTable* g_red = &tables[1];
  const HuffTable* g_blue = &tables[2];
  const HuffTable* g_alpha = &tables[3];
  const HuffTable* g_dist = &tables[4];
  int last_key = -1;

  while (pos < npix) {
    if (META) {
      int key = (y >> huffman_bits) * meta_w + (x >> huffman_bits);
      if (key != last_key) {
        int g = huffman_image[key];
        if (g < 0 || g >= num_groups) return 2;
        g_green = &tables[g * 5 + 0];
        g_red = &tables[g * 5 + 1];
        g_blue = &tables[g * 5 + 2];
        g_alpha = &tables[g * 5 + 3];
        g_dist = &tables[g * 5 + 4];
        last_key = key;
      }
    }
    int sym = g_green->decode(br);
    if (br.overrun()) return 3;
    if (sym < 256) {
      uint32_t red = g_red->decode(br);
      uint32_t blue = g_blue->decode(br);
      uint32_t alpha = g_alpha->decode(br);
      uint32_t argb = (alpha << 24) | (red << 16) | ((uint32_t)sym << 8) | blue;
      out_pixels[pos++] = argb;
      if (CACHE) cache[(uint32_t)(0x1e35a7bdu * argb) >> cache_shift] = argb;
      if (++x >= width) { x = 0; y++; }
    } else if (sym < cache_limit) {
      int length = prefix_decode(br, sym - 256);
      int dcode = g_dist->decode(br);
      int dist = plane_code_to_distance(width, prefix_decode(br, dcode));
      if (br.overrun()) return 3;
      if (dist > pos || pos + length > npix) return 4;
      const uint32_t* src = out_pixels + pos - dist;
      uint32_t* dst = out_pixels + pos;
      if (CACHE) {
        for (int k = 0; k < length; k++) {
          uint32_t argb = src[k];
          dst[k] = argb;
          cache[(uint32_t)(0x1e35a7bdu * argb) >> cache_shift] = argb;
        }
      } else if (dist >= length) {
        std::memcpy(dst, src, (size_t)length * 4);
      } else {  // overlapping pattern copy
        for (int k = 0; k < length; k++) dst[k] = src[k];
      }
      pos += length;
      x += length;
      if (x >= width) {
        y += x / width;
        x %= width;
      }
      if (META) last_key = -1;
    } else {
      if (!CACHE) return 5;
      int idx = sym - cache_limit;
      if (idx >= cache_size) return 5;
      uint32_t argb = cache[idx];
      out_pixels[pos++] = argb;
      if (++x >= width) { x = 0; y++; }
    }
  }
  if (br.overrun()) return 3;
  return 0;
}

}  // namespace

// One prefix code's per-symbol code lengths (decoder.py
// _read_code_lengths: simple 1-2 symbol codes or code-length-coded
// with 16/17/18 repeats).  Returns 0 ok, 1 invalid, 2 truncated.
static int read_code_lengths_native(BitReader& br, int alphabet,
                                    int32_t* out) {
  static const uint8_t kClOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16,
                                       6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  std::fill(out, out + alphabet, 0);
  if (br.read(1)) {  // simple code
    int num_symbols = (int)br.read(1) + 1;
    int sym0 = br.read(1) ? (int)br.read(8) : (int)br.read(1);
    if (sym0 >= alphabet) return 1;
    out[sym0] = 1;
    if (num_symbols == 2) {
      int sym1 = (int)br.read(8);
      if (sym1 >= alphabet) return 1;
      out[sym1] = 1;
    }
    return br.overrun() ? 2 : 0;
  }
  int num_codes = (int)br.read(4) + 4;
  if (num_codes > 19) return 1;
  int32_t cl_len[19] = {0};
  for (int i = 0; i < num_codes; i++) cl_len[kClOrder[i]] = (int32_t)br.read(3);
  HuffTable cl;
  if (!build_table(cl_len, 19, &cl)) return 1;
  int max_symbol = alphabet;
  if (br.read(1)) {
    int nb = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nb);
    if (max_symbol > alphabet) return 1;
  }
  int prev_len = 8, sym = 0;
  while (sym < alphabet) {
    if (max_symbol == 0) break;
    max_symbol--;
    int code = cl.decode(br);
    if (code < 16) {
      out[sym++] = code;
      if (code != 0) prev_len = code;
    } else {
      static const int kOff[3] = {3, 3, 11};
      static const int kExt[3] = {2, 3, 7};
      int repeat = kOff[code - 16] + (int)br.read(kExt[code - 16]);
      if (sym + repeat > alphabet) return 1;
      int fill = (code == 16) ? prev_len : 0;
      for (int r = 0; r < repeat; r++) out[sym++] = fill;
    }
    if (br.overrun()) return 2;
  }
  return 0;
}

extern "C" {

// Parse num_groups x 5 prefix codes' code lengths (the meta-huffman
// "huffman codes" section) in one native pass; lengths_out is the same
// concatenated layout wtpu_vp8l_decode_pixels consumes (fixed
// per-group stride = sum of the 5 alphabet sizes).
int wtpu_vp8l_read_groups(
    const uint8_t* data, uint64_t data_size, uint64_t bit_pos_in,
    int num_groups, const int32_t* alphabet_sizes,
    int32_t* lengths_out, uint64_t* bit_pos_out) {
  BitReader br{data, data_size, bit_pos_in};
  br.refill();
  int32_t* out = lengths_out;
  for (int g = 0; g < num_groups; g++) {
    for (int c = 0; c < 5; c++) {
      int rc = read_code_lengths_native(br, alphabet_sizes[c], out);
      if (rc != 0) return rc;
      out += alphabet_sizes[c];
    }
  }
  *bit_pos_out = br.bit_pos;
  return 0;
}

// Decode the pixel stream.  Group tables are described by concatenated
// code-length arrays: for group g, code c (0..4), lengths are at
// code_lengths[code_offsets[g*5+c] .. +alphabet_sizes[c]-1].
// Returns 0 on success; fills *bit_pos_out.
int wtpu_vp8l_decode_pixels(
    const uint8_t* data, uint64_t data_size, uint64_t bit_pos_in,
    int width, int height, int num_groups,
    const int32_t* alphabet_sizes, const int32_t* code_lengths,
    const int32_t* code_offsets,
    const int32_t* huffman_image, int huffman_bits, int meta_w,
    int cache_bits,
    uint32_t* out_pixels, uint64_t* bit_pos_out) {
  init_dist_map();
  BitReader br{data, data_size, bit_pos_in};
  br.refill();

  std::vector<HuffTable> tables((size_t)num_groups * 5);
  for (int g = 0; g < num_groups; g++) {
    for (int c = 0; c < 5; c++) {
      if (!build_table(code_lengths + code_offsets[g * 5 + c],
                       alphabet_sizes[c], &tables[g * 5 + c]))
        return 1;
    }
  }

  const bool meta = huffman_image != nullptr;
  const bool cache = cache_bits > 0;
  int rc;
  if (meta && cache)
    rc = decode_pixels_loop<true, true>(br, width, height, tables, num_groups,
                                        huffman_image, huffman_bits, meta_w,
                                        cache_bits, out_pixels);
  else if (meta)
    rc = decode_pixels_loop<true, false>(br, width, height, tables, num_groups,
                                         huffman_image, huffman_bits, meta_w,
                                         cache_bits, out_pixels);
  else if (cache)
    rc = decode_pixels_loop<false, true>(br, width, height, tables, num_groups,
                                         huffman_image, huffman_bits, meta_w,
                                         cache_bits, out_pixels);
  else
    rc = decode_pixels_loop<false, false>(br, width, height, tables, num_groups,
                                          huffman_image, huffman_bits, meta_w,
                                          cache_bits, out_pixels);
  if (rc) return rc;
  *bit_pos_out = br.bit_pos;
  return 0;
}

// ----------------------------------------------------------------------
// Predictor inverse transform (in-place residual → pixel).
// ----------------------------------------------------------------------

static inline uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
static inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

static inline uint32_t clamped_add_sub_full(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = clip255((int)((l >> s) & 0xff) + (int)((t >> s) & 0xff) -
                    (int)((tl >> s) & 0xff));
    out |= (uint32_t)v << s;
  }
  return out;
}
static inline uint32_t clamped_add_sub_half(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t ave = avg2(l, t);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (int)((ave >> s) & 0xff);
    int b = (int)((tl >> s) & 0xff);
    int d = a - b;
    int half = d >= 0 ? d / 2 : -((-d) / 2);
    out |= (uint32_t)clip255(a + half) << s;
  }
  return out;
}
static inline uint32_t select_pred(uint32_t l, uint32_t t, uint32_t tl) {
  int pl = 0, pt = 0;
  for (int s = 0; s < 32; s += 8) {
    int lc = (int)((l >> s) & 0xff), tc = (int)((t >> s) & 0xff),
        tlc = (int)((tl >> s) & 0xff);
    pl += tc > tlc ? tc - tlc : tlc - tc;
    pt += lc > tlc ? lc - tlc : tlc - lc;
  }
  return pl < pt ? l : t;
}

static inline uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tl,
                               uint32_t tr) {
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
    case 13: return clamped_add_sub_half(l, t, tl);
    default: return 0xff000000u;
  }
}

static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu) |
         (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u);
}

void wtpu_vp8l_add_green(uint32_t* argb, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = argb[i];
    uint32_t g = (v >> 8) & 0xff;
    uint32_t r = (((v >> 16) & 0xff) + g) & 0xff;
    uint32_t b = ((v & 0xff) + g) & 0xff;
    argb[i] = (v & 0xff00ff00u) | (r << 16) | b;
  }
}

void wtpu_vp8l_color_inverse(uint32_t* argb, int width, int height,
                             const uint32_t* timg, int bits,
                             int tiles_per_row) {
  for (int y = 0; y < height; y++) {
    uint32_t* row = argb + (int64_t)y * width;
    const uint32_t* trow = timg + (int64_t)(y >> bits) * tiles_per_row;
    int x = 0;
    while (x < width) {
      const int tx = x >> bits;
      int x1 = (tx + 1) << bits;
      if (x1 > width) x1 = width;
      const uint32_t t = trow[tx];
      const int g2r = (int8_t)(t & 0xff);
      const int g2b = (int8_t)((t >> 8) & 0xff);
      const int r2b = (int8_t)((t >> 16) & 0xff);
#if defined(__AVX2__)
      const __m256i vg2r = _mm256_set1_epi32(g2r);
      const __m256i vg2b = _mm256_set1_epi32(g2b);
      const __m256i vr2b = _mm256_set1_epi32(r2b);
      const __m256i m255 = _mm256_set1_epi32(0xff);
      const __m256i keep = _mm256_set1_epi32((int)0xff00ff00u);
      for (; x + 8 <= x1; x += 8) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(row + x));
        __m256i g = _mm256_srai_epi32(_mm256_slli_epi32(v, 16), 24);
        __m256i r = _mm256_and_si256(_mm256_srli_epi32(v, 16), m255);
        __m256i b = _mm256_and_si256(v, m255);
        r = _mm256_and_si256(
            _mm256_add_epi32(
                r, _mm256_srai_epi32(_mm256_mullo_epi32(vg2r, g), 5)),
            m255);
        __m256i rs = _mm256_srai_epi32(_mm256_slli_epi32(r, 24), 24);
        b = _mm256_and_si256(
            _mm256_add_epi32(
                _mm256_add_epi32(
                    b, _mm256_srai_epi32(_mm256_mullo_epi32(vg2b, g), 5)),
                _mm256_srai_epi32(_mm256_mullo_epi32(vr2b, rs), 5)),
            m255);
        v = _mm256_or_si256(_mm256_and_si256(v, keep),
                            _mm256_or_si256(_mm256_slli_epi32(r, 16), b));
        _mm256_storeu_si256((__m256i*)(row + x), v);
      }
#endif
      for (; x < x1; x++) {
        uint32_t v = row[x];
        int g = (int8_t)((v >> 8) & 0xff);
        int r = (int)((v >> 16) & 0xff);
        int b = (int)(v & 0xff);
        r = (r + ((g2r * g) >> 5)) & 0xff;
        b = (b + ((g2b * g) >> 5) + ((r2b * (int)(int8_t)(uint8_t)r) >> 5)) &
            0xff;
        row[x] = (v & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
      }
    }
  }
}

void wtpu_argb_to_rgba(const uint32_t* argb, uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = argb[i];
    out[4 * i + 0] = (uint8_t)(v >> 16);
    out[4 * i + 1] = (uint8_t)(v >> 8);
    out[4 * i + 2] = (uint8_t)v;
    out[4 * i + 3] = (uint8_t)(v >> 24);
  }
}

// One constant-mode row segment; with MODE a compile-time constant the
// predictor inlines, and the modes that don't read the left neighbor
// (0/2/3/4/8/9) lose the loop-carried dependency and auto-vectorize.
extern "C++" {
template <int MODE>
static void pred_inv_seg(uint32_t* row, const uint32_t* above, int x0,
                         int x1, int width) {
  for (int x = x0; x < x1; x++) {
    uint32_t tr = x + 1 < width ? above[x + 1] : row[0];
    uint32_t pred = predict(MODE, row[x - 1], above[x], above[x - 1], tr);
    row[x] = add_pixels(row[x], pred);
  }
}
}  // extern "C++"

void wtpu_vp8l_predictor_inverse(uint32_t* argb, int width, int height,
                                 const uint32_t* mode_img, int bits,
                                 int tiles_per_row) {
  // Row 0: Left chain with black at the origin.
  argb[0] = add_pixels(argb[0], 0xff000000u);
  for (int x = 1; x < width; x++) argb[x] = add_pixels(argb[x], argb[x - 1]);
  for (int y = 1; y < height; y++) {
    uint32_t* row = argb + (int64_t)y * width;
    const uint32_t* above = row - width;
    const uint32_t* modes = mode_img + (int64_t)(y >> bits) * tiles_per_row;
    row[0] = add_pixels(row[0], above[0]);  // col 0 -> Top
    int x = 1;
    while (x < width) {
      int tx = x >> bits;
      int x1 = (tx + 1) << bits;
      if (x1 > width) x1 = width;
      switch ((int)((modes[tx] >> 8) & 0xff)) {
        case 0: pred_inv_seg<0>(row, above, x, x1, width); break;
        case 1: pred_inv_seg<1>(row, above, x, x1, width); break;
        case 2: pred_inv_seg<2>(row, above, x, x1, width); break;
        case 3: pred_inv_seg<3>(row, above, x, x1, width); break;
        case 4: pred_inv_seg<4>(row, above, x, x1, width); break;
        case 5: pred_inv_seg<5>(row, above, x, x1, width); break;
        case 6: pred_inv_seg<6>(row, above, x, x1, width); break;
        case 7: pred_inv_seg<7>(row, above, x, x1, width); break;
        case 8: pred_inv_seg<8>(row, above, x, x1, width); break;
        case 9: pred_inv_seg<9>(row, above, x, x1, width); break;
        case 10: pred_inv_seg<10>(row, above, x, x1, width); break;
        case 11: pred_inv_seg<11>(row, above, x, x1, width); break;
        case 12: pred_inv_seg<12>(row, above, x, x1, width); break;
        case 13: pred_inv_seg<13>(row, above, x, x1, width); break;
        default: pred_inv_seg<0>(row, above, x, x1, width); break;
      }
      x = x1;
    }
  }
}

// ----------------------------------------------------------------------
// Encoder-side predictor selection (mirror of models/vp8l/encoder.py
// _choose_predictors): per-tile residual-histogram entropy with a small
// magnitude bias, then shared-tree refinement iterations against the
// global byte distribution under the current picks.
// Encoder context uses ORIGINAL pixels: L/T/TL/TR with 0 fills, plus the
// mode-independent edge overrides (row 0 → Left, col 0 → Top, origin →
// black).
// ----------------------------------------------------------------------

static inline uint32_t enc_pred_at(const uint32_t* a, int w, int y, int x,
                                   int mode) {
  if (y == 0) {
    if (x == 0) return 0xff000000u;
    return a[x - 1];                        // row 0 → Left
  }
  if (x == 0) return a[(size_t)(y - 1) * w]; // col 0 → Top
  uint32_t l = a[(size_t)y * w + x - 1];
  uint32_t t = a[(size_t)(y - 1) * w + x];
  uint32_t tl = a[(size_t)(y - 1) * w + x - 1];
  uint32_t tr = x + 1 < w ? a[(size_t)(y - 1) * w + x + 1]
                          : a[(size_t)y * w];   // wrap: row's first pixel
  return predict(mode, l, t, tl, tr);
}

static inline uint32_t sub_px(uint32_t x, uint32_t p) {
  uint32_t lo = ((x | 0x01000100u) - (p & 0x00ff00ffu)) & 0x00ff00ffu;
  uint32_t hi = (((x >> 8) | 0x01000100u) - ((p >> 8) & 0x00ff00ffu))
                & 0x00ff00ffu;
  return lo | (hi << 8);
}

// Per-tile cross-color chooser (mirror of encoder.py
// _choose_cross_color): coarse-to-fine ENTROPY descent on the 3.5-bit
// fixed-point multipliers g→r, g→b, r→b.  Least squares (the previous
// fit) minimizes residual variance, but the coder pays Shannon bits.
// Cost of a
// candidate = Shannon entropy of the tile's residual-byte histogram
// minus a small near-zero concentration bonus (cross-tile consistency:
// shared global trees reward residual mass concentrated around 0).
// libwebp's GetBestGreenToRed / GetBestGreenRedToBlue re-done as a
// per-tile descent.  out = th*tw*3 int8 (g2r, g2b, r2b per tile).
namespace {

struct CCCost {
  double slog2[1025];        // n -> n*log2(n)
  double wnear[16];          // near-zero bonus weights
  CCCost() {
    slog2[0] = 0.0;
    for (int n = 1; n <= 1024; n++) slog2[n] = n * std::log2((double)n);
    double e = 2.4;
    wnear[0] = 3.0;
    for (int i = 1; i < 16; i++) { wnear[i] = e; e *= 0.6; }
  }
};
static const CCCost kCC;

// Entropy + concentration bonus of one residual histogram.
static inline double cc_hist_cost(const uint16_t hist[256], int npx) {
  double s = 0.0;
  for (int i = 0; i < 256; i++) s += kCC.slog2[hist[i]];
  double near = kCC.wnear[0] * hist[0];
  for (int i = 1; i < 16; i++) near += kCC.wnear[i] * (hist[i] + hist[256 - i]);
  return kCC.slog2[npx] - s - 0.1 * near;
}

static inline int cc_clamp(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}

}  // namespace

// row_step > 1 subsamples the SCORING rows (the transform stays exact;
// only the cost histograms see fewer pixels) — the low-method speed
// knob.  gain_out (nullable): total cost saved vs the zero transform,
// letting the caller skip the cross-color-vs-none trial probe.
void wtpu_vp8l_cross_color_fit(const uint32_t* argb, int h, int w,
                               int bits, int row_step, int8_t* out,
                               double* gain_out) {
  const int tile = 1 << bits;
  const int tw = (w + tile - 1) >> bits;
  const int th = (h + tile - 1) >> bits;
  if (row_step < 1) row_step = 1;
  double gain = 0.0;
  // per-tile scratch: signed channel bytes, gathered once
  std::vector<int8_t> gs((size_t)tile * tile), rs((size_t)tile * tile),
      bs((size_t)tile * tile);
  for (int ty = 0; ty < th; ty++) {
    const int y0 = ty << bits, y1 = std::min(h, y0 + tile);
    for (int tx = 0; tx < tw; tx++) {
      const int x0 = tx << bits, x1 = std::min(w, x0 + tile);
      int npx = 0;
      for (int y = y0; y < y1; y += row_step) {
        const uint32_t* row = argb + (size_t)y * w;
        for (int x = x0; x < x1; x++) {
          uint32_t v = row[x];
          gs[npx] = (int8_t)((v >> 8) & 0xff);
          rs[npx] = (int8_t)((v >> 16) & 0xff);
          bs[npx] = (int8_t)(v & 0xff);
          npx++;
        }
      }
      uint16_t hist[256];
      auto cost_red = [&](int m) -> double {
        std::memset(hist, 0, sizeof(hist));
        for (int i = 0; i < npx; i++)
          hist[(uint8_t)((int)rs[i] - (((int)(int8_t)m * gs[i]) >> 5))]++;
        return cc_hist_cost(hist, npx);
      };
      auto cost_blue = [&](int mg, int mr) -> double {
        std::memset(hist, 0, sizeof(hist));
        for (int i = 0; i < npx; i++)
          hist[(uint8_t)((int)bs[i] - (((int)(int8_t)mg * gs[i]) >> 5)
                         - (((int)(int8_t)mr * rs[i]) >> 5))]++;
        return cc_hist_cost(hist, npx);
      };
      // green->red: +/- descent over halving deltas
      int g2r = 0;
      const double zero_red = cost_red(0);
      double best = zero_red;
      for (int delta = 32; delta >= 1; delta >>= 1) {
        for (int sgn = -1; sgn <= 1; sgn += 2) {
          const int cand = cc_clamp(g2r + sgn * delta);
          const double c = cost_red(cand);
          if (c < best) { best = c; g2r = cand; }
        }
      }
      gain += zero_red - best;
      // (green->blue, red->blue): 8-direction joint descent
      static const int kDir[8][2] = {{0, 1}, {0, -1}, {1, 0}, {-1, 0},
                                     {1, 1}, {1, -1}, {-1, 1}, {-1, -1}};
      int g2b = 0, r2b = 0;
      const double zero_blue = cost_blue(0, 0);
      best = zero_blue;
      for (int delta = 32; delta >= 1; delta >>= 1) {
        for (int d = 0; d < 8; d++) {
          const int cg = cc_clamp(g2b + kDir[d][0] * delta);
          const int cr = cc_clamp(r2b + kDir[d][1] * delta);
          const double c = cost_blue(cg, cr);
          if (c < best) { best = c; g2b = cg; r2b = cr; }
        }
      }
      gain += zero_blue - best;
      const int t = ty * tw + tx;
      out[3 * t + 0] = (int8_t)g2r;
      out[3 * t + 1] = (int8_t)g2b;
      out[3 * t + 2] = (int8_t)r2b;
    }
  }
  // Subsampled scoring sees 1/row_step of the pixels; scale the gain
  // back to full-image bits for the caller's header-vs-savings test.
  if (gain_out) *gain_out = gain * row_step;
}

// Forward predictor transform: residual = pixel - pred(tile mode), with
// the mode-independent edge rules (row 0 → Left, col 0 → Top, origin →
// black).  Mirror of models/vp8l/encoder.py _apply_predictor_transform.
void wtpu_vp8l_predictor_residual(const uint32_t* argb, int h, int w,
                                  int bits, const uint32_t* mode_img,
                                  int tiles_per_row, uint32_t* out) {
  for (int y = 0; y < h; y++) {
    const uint32_t* row = argb + (size_t)y * w;
    const uint32_t* mrow = mode_img + (size_t)(y >> bits) * tiles_per_row;
    uint32_t* orow = out + (size_t)y * w;
    int x = 0;
    while (x < w) {
      const int tx = x >> bits;
      int x1 = (tx + 1) << bits;
      if (x1 > w) x1 = w;
      const int mode = (int)((mrow[tx] >> 8) & 0xff);
      for (; x < x1; x++)
        orow[x] = sub_px(row[x], enc_pred_at(argb, w, y, x, mode));
    }
  }
}

// Stage-1 histogram scan with the mode specialized at compile time:
// hoists the predictor switch and the edge branches out of the pixel
// loop (the generic enc_pred_at per-pixel path costs ~3x).
extern "C++" {
template <int MODE>
static void cp_scan_mode(const uint32_t* argb, int h, int w, int bits,
                         int row_step, int tw, uint32_t* hbase) {
  for (int y = 0; y < h; y += row_step) {
    const uint32_t* row = argb + (size_t)y * w;
    uint32_t* hrow = hbase + (size_t)(y >> bits) * tw * 1024;
    auto bump = [&](int xx, uint32_t res) {
      uint32_t* hh = hrow + (size_t)(xx >> bits) * 1024;
      hh[(res >> 24) & 0xff]++;
      hh[256 + ((res >> 16) & 0xff)]++;
      hh[512 + ((res >> 8) & 0xff)]++;
      hh[768 + (res & 0xff)]++;
    };
    if (y == 0 || w <= 2) {
      for (int x = 0; x < w; x++)
        bump(x, sub_px(row[x], enc_pred_at(argb, w, y, x, MODE)));
      continue;
    }
    bump(0, sub_px(row[0], enc_pred_at(argb, w, y, 0, MODE)));
    const uint32_t* up = row - w;
    for (int x = 1; x < w - 1; x++)
      bump(x, sub_px(row[x], predict(MODE, row[x - 1], up[x],
                                     up[x - 1], up[x + 1])));
    bump(w - 1, sub_px(row[w - 1],
                       enc_pred_at(argb, w, y, w - 1, MODE)));
  }
}

typedef void (*CpScanFn)(const uint32_t*, int, int, int, int, int,
                         uint32_t*);
static const CpScanFn kCpScan[14] = {
    cp_scan_mode<0>, cp_scan_mode<1>, cp_scan_mode<2>, cp_scan_mode<3>,
    cp_scan_mode<4>, cp_scan_mode<5>, cp_scan_mode<6>, cp_scan_mode<7>,
    cp_scan_mode<8>, cp_scan_mode<9>, cp_scan_mode<10>, cp_scan_mode<11>,
    cp_scan_mode<12>, cp_scan_mode<13>};
}  // extern "C++"

// row_step > 1 subsamples the SCORING rows only (residuals still use
// the true neighbours from the full image) — the low-method speed knob.
void wtpu_vp8l_choose_predictors(const uint32_t* argb, int h, int w,
                                 int bits, int refine_iters, int row_step,
                                 uint8_t* modes_out) {
  const int tw = (w + (1 << bits) - 1) >> bits;
  const int th = (h + (1 << bits) - 1) >> bits;
  const int T = tw * th;
  if (row_step < 1) row_step = 1;

  // Keep every mode's per-tile histograms when they fit: stage 2's
  // refinement costs are pure histogram algebra (cost_acc[t][m] =
  // -sum_bins hist[m][t][bin]*logp[bin]; glob = sum_t hist[modes[t]]),
  // so storing the (14, T, 1024) tensor replaces the 14 full-image
  // residual re-scans PER refinement iteration with tiny table sums —
  // identical numbers, ~4x less work overall (the card's chooser,
  // ops/kernels/vp8l_predictor.cu, scores the same histograms in
  // fixed point).
  const size_t kHistCap = (size_t)192 << 20;   // bytes
  const bool keep_all =
      (size_t)T * 1024 * 14 * sizeof(uint32_t) <= kHistCap;

  // Stage 1: per-tile entropy (+0.04*folded magnitude bias) per mode.
  std::vector<double> best_cost((size_t)T, 1e300);
  std::vector<uint8_t> modes((size_t)T, 0);
  // The (14, T, 1024) tensor is tens of MB; reusing a thread-local
  // arena avoids re-faulting those pages on every call (worth ~25% of
  // the whole chooser).  Safe under the trial thread pool: one arena
  // per thread.  memset below replaces the vector's zero-fill.
  static thread_local std::vector<uint32_t> hist_arena;
  const size_t need = (size_t)(keep_all ? 14 : 1) * T * 1024;
  if (hist_arena.size() < need) hist_arena.resize(need);
  uint32_t* hist_all = hist_arena.data();
  uint32_t* hist = hist_arena.data();
  if (keep_all)
    std::memset(hist_all, 0, (size_t)14 * T * 1024 * sizeof(uint32_t));
  std::vector<double> npx((size_t)T, 0.0);
  int npx_max = 0;
  for (int y = 0; y < h; y += row_step)
    for (int x = 0; x < w; x++)
      npx[(size_t)(y >> bits) * tw + (x >> bits)] += 1.0;
  for (int t = 0; t < T; t++)
    if ((int)npx[t] > npx_max) npx_max = (int)npx[t];
  // float n*log2(n) LUT sized to the largest per-bin count: the
  // per-tile cost reduce (14 x T x 1024 bins, plus refine iterations)
  // dominates the chooser, and float + a branch-free gatherable LUT
  // lets the compiler vectorize it (~4x; mode picks only flip on
  // sub-ulp ties, within the suite's 95%-agreement tolerance).
  std::vector<float> slog2f((size_t)npx_max + 1);
  slog2f[0] = 0.0f;
  for (int i = 1; i <= npx_max; i++)
    slog2f[i] = (float)(i * std::log2((double)i));
  float magb4[1024];
  for (int i = 0; i < 1024; i++) {
    int b = i & 255;
    int folded = b < 256 - b ? b : 256 - b;
    if (b == 0) folded = 0;
    magb4[i] = 0.04f * folded;
  }

  for (int mode = 0; mode < 14; mode++) {
    uint32_t* hbase = keep_all ? hist_all + (size_t)mode * T * 1024
                               : hist;
    if (!keep_all)
      std::memset(hbase, 0, (size_t)T * 1024 * sizeof(uint32_t));
    kCpScan[mode](argb, h, w, bits, row_step, tw, hbase);
    for (int t = 0; t < T; t++) {
      const uint32_t* hh = hbase + (size_t)t * 1024;
      double n_log_n = 4.0 * npx[t] * (npx[t] > 0 ? std::log2(npx[t]) : 0.0);
      float s = 0.0f, bias = 0.0f;
#if defined(__AVX2__)
      // Residual histograms are ~75% empty and the zeros cluster, so an
      // 8-wide all-zero skip + LUT gather beats both the branchy scalar
      // loop and a dense vector pass.
      __m256 vs = _mm256_setzero_ps(), vb = _mm256_setzero_ps();
      for (int i = 0; i < 1024; i += 8) {
        __m256i c = _mm256_loadu_si256((const __m256i*)(hh + i));
        if (_mm256_testz_si256(c, c)) continue;
        vs = _mm256_add_ps(
            vs, _mm256_i32gather_ps(slog2f.data(), c, 4));
        vb = _mm256_fmadd_ps(_mm256_cvtepi32_ps(c),
                             _mm256_loadu_ps(magb4 + i), vb);
      }
      float tmp[8];
      _mm256_storeu_ps(tmp, vs);
      for (int k = 0; k < 8; k++) s += tmp[k];
      _mm256_storeu_ps(tmp, vb);
      for (int k = 0; k < 8; k++) bias += tmp[k];
#else
      for (int i = 0; i < 1024; i++) {
        uint32_t c = hh[i];
        if (c) {
          s += slog2f[c];
          bias += (float)c * magb4[i];
        }
      }
#endif
      double cost = n_log_n - (double)s + (double)bias;
      if (cost < best_cost[t]) {
        best_cost[t] = cost;
        modes[t] = (uint8_t)mode;
      }
    }
  }

  // Stage 2: refinement against the global shared-tree distribution.
  // With the per-mode histograms kept, every quantity is histogram
  // algebra (identical doubles: per-pixel -logp sums ARE per-bin
  // count*(-logp) sums); the pixel re-scan path remains the fallback
  // for tile grids too large to keep.
  std::vector<double> cost_acc((size_t)T);
  for (int it = 0; it < refine_iters; it++) {
    double glob[4][256];
    std::memset(glob, 0, sizeof(glob));
    if (keep_all) {
      for (int t = 0; t < T; t++) {
        const uint32_t* hh =
            hist_all + ((size_t)modes[t] * T + t) * 1024;
        for (int i = 0; i < 1024; i++) glob[i >> 8][i & 255] += hh[i];
      }
    } else {
      for (int y = 0; y < h; y += row_step) {
        const uint32_t* row = argb + (size_t)y * w;
        const uint8_t* mrow = modes.data() + (size_t)(y >> bits) * tw;
        for (int x = 0; x < w; x++) {
          uint32_t res = sub_px(row[x],
                                enc_pred_at(argb, w, y, x, mrow[x >> bits]));
          glob[0][(res >> 24) & 0xff] += 1.0;
          glob[1][(res >> 16) & 0xff] += 1.0;
          glob[2][(res >> 8) & 0xff] += 1.0;
          glob[3][res & 0xff] += 1.0;
        }
      }
    }
    double logp[4][256];
    for (int ch = 0; ch < 4; ch++) {
      double tot = 0.0;
      for (int b = 0; b < 256; b++) tot += glob[ch][b];
      for (int b = 0; b < 256; b++)
        logp[ch][b] = std::log2((glob[ch][b] + 0.1) / (tot + 25.6));
    }
    double mcount[14] = {0};
    for (int t = 0; t < T; t++) mcount[modes[t]] += 1.0;
    double mode_cost[14];
    for (int m = 0; m < 14; m++)
      mode_cost[m] = -std::log2((mcount[m] + 0.1) / ((double)T + 1.4));

    std::vector<uint8_t> new_modes((size_t)T, 0);
    std::vector<double> best((size_t)T, 1e300);
    for (int mode = 0; mode < 14; mode++) {
      if (keep_all) {
        float nlp_flat[1024];
        for (int i = 0; i < 1024; i++)
          nlp_flat[i] = (float)-logp[i >> 8][i & 255];
        for (int t = 0; t < T; t++) {
          const uint32_t* hh =
              hist_all + ((size_t)mode * T + t) * 1024;
          float acc = 0.0f;
#if defined(__AVX2__)
          __m256 va = _mm256_setzero_ps();
          for (int i = 0; i < 1024; i += 8) {
            __m256i c = _mm256_loadu_si256((const __m256i*)(hh + i));
            if (_mm256_testz_si256(c, c)) continue;
            va = _mm256_fmadd_ps(_mm256_cvtepi32_ps(c),
                                 _mm256_loadu_ps(nlp_flat + i), va);
          }
          float tmp[8];
          _mm256_storeu_ps(tmp, va);
          for (int k = 0; k < 8; k++) acc += tmp[k];
#else
          for (int i = 0; i < 1024; i++)
            acc += (float)hh[i] * nlp_flat[i];
#endif
          cost_acc[t] = (double)acc;
        }
      } else {
        std::fill(cost_acc.begin(), cost_acc.end(), 0.0);
        for (int y = 0; y < h; y += row_step) {
          const uint32_t* row = argb + (size_t)y * w;
          double* crow = cost_acc.data() + (size_t)(y >> bits) * tw;
          for (int x = 0; x < w; x++) {
            uint32_t res = sub_px(row[x], enc_pred_at(argb, w, y, x, mode));
            crow[x >> bits] -= logp[0][(res >> 24) & 0xff]
                               + logp[1][(res >> 16) & 0xff]
                               + logp[2][(res >> 8) & 0xff]
                               + logp[3][res & 0xff];
          }
        }
      }
      for (int t = 0; t < T; t++) {
        double c = cost_acc[t] + mode_cost[mode];
        if (c < best[t]) { best[t] = c; new_modes[t] = (uint8_t)mode; }
      }
    }
    if (std::memcmp(new_modes.data(), modes.data(), (size_t)T) == 0) break;
    modes = new_modes;
  }
  std::memcpy(modes_out, modes.data(), (size_t)T);
}


}  // extern "C"
