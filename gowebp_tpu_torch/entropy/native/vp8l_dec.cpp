// VP8L (WebP lossless) decode hot loops, native host layer.
//
// Sequential bit-level work runs on the host: this file holds the
// prefix-code section reader (wtpu_vp8l_read_groups), the per-pixel
// Huffman/LZ77/colour-cache decode loop (wtpu_vp8l_decode_pixels) and
// the inverse transforms (add-green, cross-colour, predictor) plus the
// ARGB -> RGBA repack, driven from models/vp8l/ via ctypes with the GIL
// released.  Written from the lossless bitstream spec.
//
// Build: g++ -O3 -fPIC -shared (see native_loader.py).

#if defined(__SSE2__)
#include <immintrin.h>
#endif
#include <algorithm>
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
}  // extern "C"
