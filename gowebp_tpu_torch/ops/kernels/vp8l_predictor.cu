// The VP8L encoder's per-tile predictor chooser: for each (1 << bits)-
// square tile of an ARGB image, the one of the 14 VP8L predictors whose
// residuals code cheapest (ops/lossless.py says what it computes).
//
// Replaces gowebp_tpu/ops/lossless_jax.py:269 predictor_search_entropy,
// which the JAX package ran in XLA (no pallas_call): one pass built a
// (14, T, 4, 256) int32 histogram tensor in device memory from int8
// one-hot chunks (235 MB for a 1 MP image at bits 4) and scored it in
// float32.  Here no histogram leaves shared memory.
//
// One launch a pass: stage 1 (refine = 0) or a refinement round
// (refine = 1).  Every score is an int64 sum of fixed-point terms from
// `tab` (float64 values scaled by 2^40 and rounded on the host:
// ops/lossless.py stage1_table and refine_table), so any order of the sums
// gives the plain version's integers, and the pick is argmin's: the least
// score, the lowest mode on a tie.
//
// Stage 1 scores while it counts.  A tile's score of mode m is
// 4 nlogn(n) + sum_b (h_b bias(b) - nlogn(h_b)) over its 1024 bins.  Each
// increment of bin b from `old` to `old + 1` adds bias(b) - d1(old), d1(n) =
// nlogn(n + 1) - nlogn(n): summed over the increments, in any order, the
// d1 terms telescope to sum_b nlogn(h_b) (nlogn(0) = 0), so there is no
// scoring sweep over the 14 x 1024 bins.  The counts live in shared
// memory, packed into 32-bit words (16 bits a count from bits 4 on, where
// a tile reaches 1,024, channels 0 and 2 of a byte value sharing a word, 1
// and 3; 8 bits up to bits 3, 64 at most, the four channels of a byte
// value in one word): no count carries into its neighbour, a field's
// shift is the same for every byte, and an atomic that returns the old
// word gives `old`; a lane with no increment adds to a scratch word of its
// own, so the atomics need no branch.  The bias and d1 tables are in
// shared memory.  The hot bin, byte 0 of a channel, is counted apart: a
// reduction a mode over the warp (over its half holding a 16-pixel tile)
// adds the lanes' zero bytes of the four channels to the tile's 56
// counts `zc`, and the pick scores those bins from their final counts;
// the other bytes take the atomics.  (Counting byte 0 by a
// ballot a channel and one atomic of its lanes, or by a __match_any_sync
// on the whole bin key, and reading the tables through __ldg, were timed
// slower on photos: PERF.md.)  A block of tiles whose alphas, and those
// their predictions read, are all 255 has every mode's alpha residuals 0,
// the same score in every mode: it leaves channel 0 out and scores it
// from the pixel count.
//
// A refinement round scores by lookups: a round's score is linear in the
// counts, sum_b h_b q(b) + the mode's cost, so each thread adds q of its
// pixels' 14 x 4 residual bytes into 14 int64 registers, from the round's
// 1,038-entry table in shared memory.  No 14-mode histogram exists.  A
// warp whose pixels are opaque adds q(alpha byte 0) once a pixel.
//
// Both: the 14 partials are summed over a warp by a transposing butterfly
// (each shuffle step halves the values a lane keeps: 16 shuffles of a
// 64-bit value instead of 70), then over the tile's warps in shared memory;
// the tile's first 16 threads pick with four shuffles.  A second short
// sweep recomputes only the picked mode's residual and counts its 4 bins a
// pixel into a block-private 1,039-word histogram (the picks' residual
// histogram, their mode counts and the tiles that changed), which the
// block adds to the global `acc` once, at its end; the host reads `acc` to
// build the next round's table.
//
// Geometry: persistent blocks stride over the tiles, so shared memory is
// zeroed once a block; after a tile is scored its counts are cleared with
// 16-byte stores (1,792 a tile at 16 bits, 896 at 8).  A slot of threads
// owns a tile, one lane a pixel: 16 threads at bits 2, 64 at bits 3, 256
// at bits 4 and at bits 5 (four pixels a thread).  Stage 1 gives a block
// one slot at bits 4-5 and two at bits 2-3 (28 KB of counts either way); a
// round, 256 threads and 256 / slot tiles at a time.  At most 64
// registers a thread, so that 2,048 threads fit an SM (stage 1 at bits 5:
// 85, whose four pixels a thread take more).
//
// Bound on the card: by operations (the bytes, 4 H W a pass read once, are
// small beside them): stage 1, a pixel's 14 predictions and residuals and
// 56 increments, each an atomic and its delta; a round, the same
// predictions and residuals and 56 table lookups.  What it reaches instead
// is set by the instructions around each increment (the byte, the packed
// field, the predicate, a 64-bit add) and by the atomics' collisions on
// the bins next to 0: PERF.md has the numbers.

#include <climits>
#include <cstdint>

namespace {

constexpr int kModes = 14;
constexpr int kBins = 1024;           // 4 channels x 256 byte values
constexpr int kMaxCount = 1024;       // 4^5: the largest tile's pixels
constexpr int kAccWords = kBins + kModes + 1;
constexpr unsigned kFull = 0xffffffffu;

// Stage 1's table (the wrapper's layout): nlogn(n) for n in 0..1024, the
// 256 byte biases, then d1(n) = nlogn(n + 1) - nlogn(n) for n in 0..1023.
constexpr int kBiasAt = kMaxCount + 1;
// A round's table: q(bin) for the 1024 bins, then the 14 mode costs.
constexpr int kRoundTab = kBins + kModes;

template <int kBits, bool kRound>
struct Shape {
  static constexpr int kPx = 1 << (2 * kBits);              // a tile's pixels
  static constexpr int kSlotThreads = kPx < 256 ? kPx : 256;
  static constexpr int kPerThread = kPx / kSlotThreads;
  static constexpr int kThreads =
      kRound ? 256 : (kSlotThreads < 256 ? 2 * kSlotThreads : kSlotThreads);
  static constexpr int kSlots = kThreads / kSlotThreads;
  static constexpr int kSeg = kSlotThreads < 32 ? kSlotThreads : 32;
  static constexpr int kSegs = kThreads / kSeg;
  static constexpr int kSegsPerSlot = kSlotThreads / kSeg;
  // a count's width: 8 bits up to 64 pixels a tile, else 16 (1,024 fits)
  static constexpr int kCountBits = kPx <= 64 ? 8 : 16;
  static constexpr int kSlotWords = kModes * kBins * kCountBits / 32;
  static constexpr int kHistBytes = kRound ? 0 : kSlots * kSlotWords * 4;
  // at most 64 registers a thread (65,536 / (64 kThreads) blocks an SM);
  // 85 at bits 5, whose 4 pixels a thread take more
  static constexpr int kMinBlocks =
      kBits == 5 && !kRound ? 3 : 1024 / kThreads;
};

__device__ __forceinline__ uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int chan(uint32_t v, int s) {
  return (int)((v >> s) & 0xffu);
}

// L when the T-TL gradient is the smaller (the format's crossed names).
__device__ __forceinline__ uint32_t select_pred(uint32_t l, uint32_t t,
                                                uint32_t tl) {
  int pl = 0, pt = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    pl += abs(chan(t, s) - chan(tl, s));
    pt += abs(chan(l, s) - chan(tl, s));
  }
  return pl < pt ? l : t;
}

__device__ __forceinline__ uint32_t clamped_add_sub_full(uint32_t l,
                                                         uint32_t t,
                                                         uint32_t tl) {
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255(chan(l, s) + chan(t, s) - chan(tl, s)) << s;
  return out;
}

__device__ __forceinline__ uint32_t clamped_add_sub_half(uint32_t l,
                                                         uint32_t t,
                                                         uint32_t tl) {
  const uint32_t ave = avg2(l, t);
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    const int a = chan(ave, s);
    out |= (uint32_t)clip255(a + (a - chan(tl, s)) / 2) << s;  // toward 0
  }
  return out;
}

__device__ __forceinline__ uint32_t predict(int mode, uint32_t l, uint32_t t,
                                            uint32_t tl, uint32_t tr) {
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
    default: return clamped_add_sub_half(l, t, tl);
  }
}

// Byte-wise (x - p) mod 256: each byte's low 7 bits subtract with their
// top bit forced on (no borrow leaves the byte), then the top bit is x's ^
// p's ^ the borrow out of the low 7.
__device__ __forceinline__ uint32_t sub_px(uint32_t x, uint32_t p) {
  return ((x | 0x80808080u) - (p & 0x7f7f7f7fu)) ^
         ((x ^ ~p) & 0x80808080u);
}

__device__ __forceinline__ int byte_of(uint32_t r, int c) {
  return (int)((r >> (24 - 8 * c)) & 0xffu);
}

// A pixel and its neighbours, with the decoder's edge rules: row 0
// predicts L, column 0 T, the origin black (the same prediction in every
// mode); TR of the last column is the current row's first pixel.
struct Pixel {
  uint32_t x, l, t, tl, tr, edge_pred;
  bool edge;
};

__device__ __forceinline__ Pixel load_pixel(const uint32_t* __restrict__ argb,
                                            int w, int y, int x) {
  Pixel p;
  const uint32_t* row = argb + (size_t)y * w;
  p.x = __ldg(&row[x]);
  p.edge = y == 0 || x == 0;
  if (p.edge) {
    p.edge_pred = y == 0 ? (x == 0 ? 0xff000000u : __ldg(&row[x - 1]))
                         : __ldg(&row[x - w]);
    p.l = p.t = p.tl = p.tr = 0u;
  } else {
    p.edge_pred = 0u;
    p.l = __ldg(&row[x - 1]);
    p.t = __ldg(&row[x - w]);
    p.tl = __ldg(&row[x - w - 1]);
    p.tr = x + 1 < w ? __ldg(&row[x - w + 1]) : __ldg(&row[0]);
  }
  return p;
}

__device__ __forceinline__ uint32_t residual(int m, const Pixel& p) {
  return sub_px(p.x, p.edge ? p.edge_pred : predict(m, p.l, p.t, p.tl, p.tr));
}

// Sums v[0..N) over a segment of 2 * OFF lanes: each step sends the half of
// the values this lane gives up and keeps the other half, so a lane ends
// holding in v[0] the segment's sum of value `idx`.
template <int N, int OFF>
__device__ __forceinline__ void fold(long long (&v)[16], int lane, int& idx) {
  if constexpr (OFF > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
    } else {
      const bool up = lane & OFF;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const long long send = up ? v[j] : v[j + N / 2];
        const long long keep = up ? v[j + N / 2] : v[j];
        v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      if (up) idx += N / 2;
    }
    fold<(N > 1 ? N / 2 : 1), OFF / 2>(v, lane, idx);
  }
}

// atom.shared.add.u32 at a 32-bit shared-window address: the old word.
__device__ __forceinline__ unsigned atom_add_shared(unsigned addr,
                                                    unsigned v) {
  unsigned old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(addr), "r"(v));
  return old;
}

// A residual's increments in mode m's counts `hm` (1024 bins of kCountBits
// each, 32 / kCountBits to a word): channels kC0 .. 3, each byte b but 0
// scored bias(b) - d1(old).  Byte 0 is left out: the segment's count of it
// (kSeg lanes, this slot's) goes to the tile's `zc` (4 channels) instead.
// `hm` and `dummy` (this lane's scratch word, the target of a lane with no
// increment) are shared-window addresses; `s_tab` holds bias at 0 and d1
// at 256.  Branch-free: the zero count, then the atomics, then the
// gathers, so the atomics' latencies overlap.  Returns the thread's sum of
// the deltas.
template <int kC0, int kCountBits, int kSeg>
__device__ __forceinline__ long long count_scored(unsigned hm, unsigned dummy,
                                                  int* zc, uint32_t r,
                                                  bool valid, int lane,
                                                  const long long* s_tab) {
  // a mode's counts: kRows rows of 256 words, row c % kRows holding
  // channel c's bins in field c / kRows (16 bits: channels 0 and 2 share a
  // word, 1 and 3; 8 bits: the four channels of one byte value)
  constexpr int kRows = kCountBits == 8 ? 1 : 2;
  constexpr unsigned kMask = (1u << kCountBits) - 1u;
  constexpr unsigned kChanBits = 0x01010101u >> (8 * kC0);
  r = valid ? r : 0u;                 // no lane without a pixel increments
  const unsigned nonzero = ((r & 0x7f7f7f7fu) + 0x7f7f7f7fu) | r;
  const unsigned zero = valid ? (~nonzero >> 7) & kChanBits : 0u;
  // channel c's count in byte 3 - c: at most 32 a byte
  const unsigned seg = kSeg == 32 ? kFull : 0xffffu << (lane & 16);
  const unsigned sum = __reduce_add_sync(seg, zero);
  const int z = (int)((sum >> (24 - 8 * (lane & 3))) & 0xffu);
  if ((lane & (kSeg - 1)) < 4 && z) atomicAdd(&zc[lane & 3], z);
  unsigned old[4];
#pragma unroll
  for (int c = kC0; c < 4; ++c) {     // a lane with no increment: its dummy
    const int b = byte_of(r, c);
    const unsigned word = (unsigned)(((c % kRows) << 8) + b);
    old[c] = atom_add_shared(b ? hm + (word << 2) : dummy,
                             1u << ((c / kRows) * kCountBits));
  }
  long long s = 0;
#pragma unroll
  for (int c = kC0; c < 4; ++c) {
    const int b = byte_of(r, c);
    const int o = (int)((old[c] >> ((c / kRows) * kCountBits)) & kMask);
    if (b) s += s_tab[b] - s_tab[256 + o];
  }
  return s;
}

// Every alpha that the pixel's prediction reads, and its own, is 255: then
// each mode's alpha residual is 0.
__device__ __forceinline__ bool opaque(const Pixel& p) {
  return ((p.x & (p.edge ? p.edge_pred : p.l & p.t & p.tl & p.tr)) >> 24) ==
         0xffu;
}

template <int kBits, bool kRound>
__global__ void __launch_bounds__(Shape<kBits, kRound>::kThreads,
                                  Shape<kBits, kRound>::kMinBlocks)
    vp8l_predictor_kernel(const uint32_t* __restrict__ argb, int h, int w,
                          const long long* __restrict__ tab,
                          int* __restrict__ modes, int* __restrict__ acc) {
  using S = Shape<kBits, kRound>;
  constexpr int kTabLen = kRound ? kRoundTab : 256 + kMaxCount;
  extern __shared__ uint4 dyn[];                 // stage 1: the counts
  __shared__ long long s_tab[kTabLen];
  __shared__ long long part[S::kSegs][16];
  __shared__ int s_acc[kAccWords];
  __shared__ int s_best[S::kSlots];
  __shared__ int zc[kRound ? 1 : S::kSlots][kModes][4];  // byte 0's counts
  __shared__ unsigned s_dummy[32];

  const int tid = threadIdx.x, lane = tid & 31;
  const int slot = tid / S::kSlotThreads, ts_id = tid % S::kSlotThreads;
  const int ts = 1 << kBits;
  const int th = (h + ts - 1) >> kBits, tw = (w + ts - 1) >> kBits;
  const int tiles = th * tw;
  uint32_t* hist = reinterpret_cast<uint32_t*>(dyn) + slot * S::kSlotWords;
  const unsigned hist_s = (unsigned)__cvta_generic_to_shared(hist);
  const unsigned dummy_s = (unsigned)__cvta_generic_to_shared(&s_dummy[lane]);
  int(*zc_slot)[4] = zc[kRound ? 0 : slot];

  for (int i = tid; i < kAccWords; i += S::kThreads) s_acc[i] = 0;
  if constexpr (!kRound) {
    for (int i = tid; i < S::kSlots * kModes * 4; i += S::kThreads)
      (&zc[0][0][0])[i] = 0;
    for (int i = tid; i < S::kHistBytes / 16; i += S::kThreads)
      dyn[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < kTabLen; i += S::kThreads)
    s_tab[i] = __ldg(&tab[kRound ? i : kBiasAt + i]);
  __syncthreads();

  for (int t0 = blockIdx.x * S::kSlots; t0 < tiles;
       t0 += gridDim.x * S::kSlots) {
    const int tile = t0 + slot;
    const bool has = tile < tiles;
    const int y0 = has ? (tile / tw) << kBits : 0;
    const int x0 = has ? (tile % tw) << kBits : 0;
    const int th_px = min(ts, h - y0), tw_px = min(ts, w - x0);
    auto pixel_at = [&](int k, bool& valid) {
      const int p = ts_id + k * S::kSlotThreads;
      const int dy = p >> kBits, dx = p & (ts - 1);
      valid = has && dy < th_px && dx < tw_px;
      Pixel px{};
      if (valid) px = load_pixel(argb, w, y0 + dy, x0 + dx);
      return px;
    };

    // an opaque block of tiles (every alpha its predictions read is 255)
    // has every mode's alpha residuals 0: the same score in every mode, so
    // channel 0 is left out and its terms added once a mode at the pick
    Pixel first{};
    bool ok = true, first_valid = false;
#pragma unroll 1
    for (int k = 0; k < S::kPerThread; ++k) {
      bool valid;
      const Pixel px = pixel_at(k, valid);
      ok = ok && (!valid || opaque(px));
      if (k == 0) {
        first = px;
        first_valid = valid;
      }
    }
    const bool skip0 = !kRound && __syncthreads_and(ok);

    long long s[16], alpha0 = 0;
#pragma unroll
    for (int m = 0; m < 16; ++m) s[m] = 0;
#pragma unroll 1
    for (int k = 0; k < S::kPerThread; ++k) {
      bool valid = first_valid;
      const Pixel px = S::kPerThread == 1 ? first : pixel_at(k, valid);
      const bool wskip = kRound && __all_sync(kFull, !valid || opaque(px));
      if (kRound && wskip && valid) alpha0 += s_tab[0];
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        const uint32_t r = residual(m, px);
        if constexpr (kRound) {       // an opaque warp: alpha's q(0) apart
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c == 0 && wskip) continue;
            const long long q = s_tab[(c << 8) + byte_of(r, c)];
            if (valid) s[m] += q;
          }
        } else {
          const unsigned hm = hist_s + m * (S::kSlotWords / kModes) * 4;
          if (skip0)
            s[m] += count_scored<1, S::kCountBits, S::kSeg>(
                hm, dummy_s, zc_slot[m], r, valid, lane, s_tab);
          else
            s[m] += count_scored<0, S::kCountBits, S::kSeg>(
                hm, dummy_s, zc_slot[m], r, valid, lane, s_tab);
        }
      }
    }

    if constexpr (kRound) {
#pragma unroll
      for (int m = 0; m < kModes; ++m) s[m] += alpha0;
    }
    int idx = 0;
    fold<16, S::kSeg / 2>(s, lane, idx);
    if (idx < kModes && (S::kSeg == 16 || !(lane & 1)))
      part[tid / S::kSeg][idx] = s[0];
    __syncthreads();

    if constexpr (!kRound) {          // all counted: clear for the next tile
      uint4* h4 = reinterpret_cast<uint4*>(hist);
      for (int i = ts_id; i < S::kSlotWords / 4; i += S::kSlotThreads)
        h4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (ts_id < 32) {                 // the slot's first warp picks
      const int m = ts_id & 15;
      const int npx = th_px * tw_px;
      long long cost = LLONG_MAX;
      if (m < kModes) {
        if constexpr (kRound) {
          cost = s_tab[kBins + m];
        } else {                      // + byte 0's bins counted apart
          cost = 4 * __ldg(&tab[npx]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int z = c == 0 && skip0 ? npx : zc_slot[m][c];
            cost += z * __ldg(&tab[kBiasAt]) - __ldg(&tab[z]);
          }
        }
#pragma unroll
        for (int k = 0; k < S::kSegsPerSlot; ++k)
          cost += part[slot * S::kSegsPerSlot + k][m];
      }
      int best = m;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const long long oc = __shfl_xor_sync(kFull, cost, off);
        const int om = __shfl_xor_sync(kFull, best, off);
        if (oc < cost || (oc == cost && om < best)) {
          cost = oc;
          best = om;
        }
      }
      if constexpr (!kRound) {
        if (ts_id < kModes) {
#pragma unroll
          for (int c = 0; c < 4; ++c) zc_slot[ts_id][c] = 0;
        }
      }
      if (ts_id == 0 && has) {
        if (kRound && modes[tile] != best) atomicAdd(&s_acc[kBins + kModes], 1);
        modes[tile] = best;
        atomicAdd(&s_acc[kBins + best], 1);
        s_best[slot] = best;
      }
    }
    __syncthreads();

    // the picks' residual histogram: the picked mode's bins of each pixel
    const int best = has ? s_best[slot] : 0;
#pragma unroll 1
    for (int k = 0; k < S::kPerThread; ++k) {
      bool valid = first_valid;
      const Pixel px = S::kPerThread == 1 ? first : pixel_at(k, valid);
      const uint32_t r = valid ? residual(best, px) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int b = byte_of(r, c);
        const bool hot = valid && b == 0;
        const unsigned mask = __ballot_sync(kFull, hot);
        if (hot) {
          if (lane == __ffs(mask) - 1) atomicAdd(&s_acc[c << 8], __popc(mask));
        } else if (valid) {
          atomicAdd(&s_acc[(c << 8) | b], 1);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kAccWords; i += S::kThreads)
    if (s_acc[i]) atomicAdd(&acc[i], s_acc[i]);
}

// Launches one pass of the <kBits, kRound> kernel: persistent blocks, as
// many as the card holds at once, no more than the tiles need, each taking
// an equal share of them.
template <int kBits, bool kRound>
cudaError_t launch_pass(const uint32_t* argb, int h, int w,
                        const long long* tab, int* modes, int* acc,
                        cudaStream_t stream) {
  using S = Shape<kBits, kRound>;
  auto kernel = vp8l_predictor_kernel<kBits, kRound>;
  // once a process (the card's SM layout and the kernel's resources do
  // not change): allow the dynamic shared memory, read the occupancy
  static const int per_sm = [kernel]() {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kHistBytes) != cudaSuccess)
      return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, S::kThreads, S::kHistBytes) != cudaSuccess)
      return 0;
    return n;
  }();
  if (per_sm <= 0) {
    cudaGetLastError();
    return cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((h + (1 << kBits) - 1) >> kBits) *
                          ((w + (1 << kBits) - 1) >> kBits);
  const long long groups = (tiles + S::kSlots - 1) / S::kSlots;
  const long long most = (long long)sms * per_sm;
  const long long each = (groups + most - 1) / most;
  const int blocks = (int)((groups + each - 1) / each);
  kernel<<<blocks, S::kThreads, S::kHistBytes, stream>>>(argb, h, w, tab,
                                                        modes, acc);
  return cudaGetLastError();
}

template <int kBits>
cudaError_t launch_bits(const uint32_t* argb, int h, int w,
                        const long long* tab, int refine, int* modes,
                        int* acc, cudaStream_t s) {
  return refine ? launch_pass<kBits, true>(argb, h, w, tab, modes, acc, s)
                : launch_pass<kBits, false>(argb, h, w, tab, modes, acc, s);
}

}  // namespace

// Zeroes `acc` and launches one pass over the tiles on `stream`; returns
// the CUDA error code.  tab: stage 1 (refine = 0), nlogn(n) for n in
// 0..1024, the 256 byte biases, then nlogn(n + 1) - nlogn(n) for n in
// 0..1023; a round (refine = 1), the 1024 bins' -log2 p then the 14 mode
// costs.
extern "C" int vp8l_predictor_launch(const uint32_t* argb, int h, int w,
                                     int bits, const long long* tab,
                                     int refine, int* modes, int* acc,
                                     void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(acc, 0, kAccWords * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  switch (bits) {
#define VP8L_BITS(b) \
  case b:            \
    return (int)launch_bits<b>(argb, h, w, tab, refine, modes, acc, s)
    VP8L_BITS(2);
    VP8L_BITS(3);
    VP8L_BITS(4);
    VP8L_BITS(5);
#undef VP8L_BITS
    default: return (int)cudaErrorInvalidValue;
  }
}
