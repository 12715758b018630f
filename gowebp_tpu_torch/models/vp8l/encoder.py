"""VP8L (WebP lossless) encoder: the spatially coded image stream.

The half of the lossless encoder that the lossy encode's ALPH chunk
needs (``encode_vp8l_alpha``): an image with no transforms, coded with
backward references (the native hash-chain, run-length and cost-model
parses), a colour cache, and either one set
of five prefix codes or tile histograms clustered into groups (the
meta-prefix image).  Parsing and symbol emission run in the native layer
(entropy/native/encode.cpp); a failed build of it raises.  The
transforms (predictor, cross-colour, subtract-green, palette) and the
lossless entry point are not here yet.  Written from the lossless
bitstream spec.  The ALPH coder always runs at quality 75, method 4, on
a non-palette image, so those are constants here (``STREAM_QUALITY``,
``STREAM_METHOD``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ...constants import (CODE_LENGTH_CODE_ORDER, NUM_CODE_LENGTH_CODES,
                          NUM_DISTANCE_CODES, NUM_LENGTH_CODES,
                          NUM_LITERAL_CODES)
from ...entropy.bitio import BitWriter
from ...entropy.huffman import build_code_lengths, canonical_codes
from ...entropy.native_loader import get_lib
from . import transforms_np as tnp

_INV_LN2 = 1.0 / np.log(2.0)

STREAM_QUALITY = 75
STREAM_METHOD = 4
CHAIN_DEPTH = 8 + STREAM_QUALITY // 5     # hash-chain walk budget

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def _log2f(x):
    """log2 through np.log (faster than np.log2 in some numpy builds);
    callers bias counts by a tiny epsilon.  Cost estimates only."""
    return np.log(x) * _INV_LN2


def prefix_encode(value: int) -> tuple[int, int, int]:
    """1-based value → (code, extra_bits_count, extra_bits_value)."""
    u = value - 1
    if u < 4:
        return u, 0, 0
    e = u.bit_length() - 2
    if u < (3 << e):
        return 2 * e + 2, e, u - (2 << e)
    return 2 * e + 3, e, u - (3 << e)


def _reverse_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


# ---------------------------------------------------------------------------
# Prefix-code storage
# ---------------------------------------------------------------------------


class HuffmanWriteCode:
    """Canonical code ready for emission: lengths + LSB-first reversed bits."""

    __slots__ = ("lengths", "bits")

    def __init__(self, lengths: np.ndarray):
        self.lengths = lengths.astype(np.int32)
        codes = canonical_codes(lengths)
        self.bits = np.array(
            [_reverse_bits(int(c), int(ln)) for c, ln in zip(codes, lengths)],
            dtype=np.uint32,
        )

    def write_symbol(self, bw: BitWriter, sym: int) -> None:
        bw.put_bits(int(self.bits[sym]), int(self.lengths[sym]))


def _tokenize_code_lengths(lengths: np.ndarray):
    """RLE-tokenize per the 16/17/18 repeat scheme → [(sym, extra_bits, extra)]."""
    tokens = []
    n = len(lengths)
    i = 0
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                k = min(r, 138)
                tokens.append((18, 7, k - 11))
                r -= k
            while r >= 3:
                k = min(r, 10)
                tokens.append((17, 3, k - 3))
                r -= k
            tokens.extend([(0, 0, 0)] * r)
        else:
            # First occurrence written literally; 16 repeats the previous
            # nonzero length, so it also works right after it.
            tokens.append((v, 0, 0))
            r = run - 1
            while r >= 3:
                k = min(r, 6)
                tokens.append((16, 2, k - 3))
                r -= k
            tokens.extend([(v, 0, 0)] * r)
        i += run
    return tokens


def store_huffman_code(bw: BitWriter, lengths: np.ndarray) -> HuffmanWriteCode:
    """Write one prefix-code description; returns the emission code."""
    used = np.flatnonzero(lengths > 0)
    if len(used) == 0:
        # Unused tree: store as trivial simple code (symbol 0).
        bw.put_bits(1, 1)   # simple
        bw.put_bits(0, 1)   # num_symbols - 1 = 0
        bw.put_bits(0, 1)   # is_8bit = 0 (1-bit symbol)
        bw.put_bits(0, 1)   # symbol 0
        out = np.zeros_like(lengths)
        out[0] = 1
        code = HuffmanWriteCode(out)
        code.lengths[0] = 0  # zero-bit single-symbol code (never emitted)
        return code

    if len(used) <= 2 and used[-1] < 256:
        # Simple code.
        bw.put_bits(1, 1)
        bw.put_bits(len(used) - 1, 1)
        first = int(used[0])
        if first <= 1:
            bw.put_bits(0, 1)       # 1-bit first symbol
            bw.put_bits(first, 1)
        else:
            bw.put_bits(1, 1)
            bw.put_bits(first, 8)
        if len(used) == 2:
            bw.put_bits(int(used[1]), 8)
        # Decoder assigns length-1 codes (or 0 bits when single).
        out = np.zeros_like(lengths)
        if len(used) == 1:
            out[used[0]] = 1
            code = HuffmanWriteCode(out)
            code.lengths[used[0]] = 0   # single symbol: zero bits on emit
            return code
        out[used] = 1
        return HuffmanWriteCode(out)

    bw.put_bits(0, 1)  # not simple
    tokens = _tokenize_code_lengths(lengths)
    # Histogram of code-length symbols → code-length code.
    cl_hist = np.zeros(NUM_CODE_LENGTH_CODES, np.int64)
    for sym, _, _ in tokens:
        cl_hist[sym] += 1
    cl_lengths = build_code_lengths(cl_hist, max_depth=7)
    if cl_lengths.max(initial=0) == 0:
        cl_lengths[0] = 1
    cl_code = HuffmanWriteCode(cl_lengths)
    # A single-symbol code-length code still needs a nonzero length in
    # the header; the decoder reads it as zero-bit, and so does emission.
    used_cl = np.flatnonzero(cl_lengths > 0)
    if len(used_cl) == 1:
        cl_code.lengths[used_cl[0]] = 0

    # Trim trailing zeros in the CODE_LENGTH_CODE_ORDER listing (min 4).
    order_lengths = [int(cl_lengths[CODE_LENGTH_CODE_ORDER[i]])
                     for i in range(NUM_CODE_LENGTH_CODES)]
    num_codes = NUM_CODE_LENGTH_CODES
    while num_codes > 4 and order_lengths[num_codes - 1] == 0:
        num_codes -= 1
    bw.put_bits(num_codes - 4, 4)
    for i in range(num_codes):
        bw.put_bits(order_lengths[i], 3)
    bw.put_bits(0, 1)  # no max_symbol trick
    for sym, ebits, extra in tokens:
        cl_code.write_symbol(bw, sym)
        if ebits:
            bw.put_bits(extra, ebits)
    return HuffmanWriteCode(lengths)


# ---------------------------------------------------------------------------
# Backward references
# ---------------------------------------------------------------------------

MIN_COPY_LEN = 4
MAX_COPY_LEN = 4095


@dataclass
class RefStream:
    """Parallel arrays of ops: 0 literal (argb), 1 copy (length, dist),
    2 colour-cache hit (index in ``lengths``)."""

    ops: np.ndarray        # (n,) uint8
    argb: np.ndarray       # (n,) uint32 (literals; undefined for copies)
    lengths: np.ndarray    # (n,) int32
    dists: np.ndarray      # (n,) int32


def _native_refs(fn, argb: np.ndarray, *args) -> RefStream:
    """Run one of the native parsers over the flattened image."""
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = len(flat)
    ops = np.zeros(n, np.uint8)
    argbs = np.zeros(n, np.uint32)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    n_ops = fn(_ptr(flat, _u32p), n, *args, _ptr(ops, _u8p),
               _ptr(argbs, _u32p), _ptr(lens, _i32p), _ptr(dists, _i32p))
    return RefStream(ops[:n_ops], argbs[:n_ops], lens[:n_ops], dists[:n_ops])


def build_backward_refs(argb: np.ndarray, width: int) -> RefStream:
    """Greedy run-based LZ77: maximal runs matching at distance 1 (left)
    and ``width`` (above), the two dominant distances (native walk)."""
    return _native_refs(get_lib().wtpu_vp8l_greedy_refs, argb, width,
                        MIN_COPY_LEN, MAX_COPY_LEN)


def build_refs_lz77(argb: np.ndarray, width: int,
                    cache_bits: int) -> RefStream:
    """Native hash-chain LZ77 (+ colour cache)."""
    return _native_refs(get_lib().wtpu_vp8l_hashchain_refs, argb, width,
                        CHAIN_DEPTH, cache_bits)


def _pick_cache_bits(refs: RefStream, argb: np.ndarray,
                     max_bits: int = 10) -> int:
    """Best cache_bits (0..max) by native one-pass simulation."""
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    scores = np.zeros(max_bits + 1, np.float64)
    get_lib().wtpu_vp8l_cache_score(
        _ptr(refs.ops, _u8p), _ptr(refs.argb, _u32p),
        _ptr(refs.lengths, _i32p), len(refs.ops), _ptr(flat, _u32p),
        max_bits, scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return int(np.argmin(scores))


def _apply_cache_native(refs: RefStream, argb: np.ndarray,
                        cache_bits: int) -> None:
    """In-place literal→cache-hit rewrite of a cache-less refs stream."""
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    get_lib().wtpu_vp8l_cache_apply(
        _ptr(refs.ops, _u8p), _ptr(refs.argb, _u32p),
        _ptr(refs.lengths, _i32p), len(refs.ops), _ptr(flat, _u32p),
        cache_bits)


def _symbol_costs(h: np.ndarray) -> np.ndarray:
    """-log2 probability per symbol (bits), smoothed for unseen symbols."""
    tot = float(h.sum())
    if tot <= 0:
        return np.full(len(h), 8.0, np.float32)
    p = (h.astype(np.float64) + 0.2) / (tot + 0.2 * len(h))
    return (-_log2f(p + 1e-12)).astype(np.float32)


def build_refs_optimal(argb: np.ndarray, width: int, cache_bits: int,
                       seed: RefStream) -> RefStream:
    """Cost-model optimal parse (native DP): the greedy parse ``seed``
    supplies the symbol-cost model, the DP finds the cheapest path over
    pixel positions and rewrites literals as colour-cache hits."""
    g, r, b, a, d = _build_histograms(seed, width, cache_bits)
    gc = _symbol_costs(g[:280])
    costs = [np.ascontiguousarray(cst, np.float32) for cst in
             (gc, _symbol_costs(r), _symbol_costs(b), _symbol_costs(a),
              _symbol_costs(d))]
    lut_arr = _build_dist_lut_array(width)
    f32p = ctypes.POINTER(ctypes.c_float)
    return _native_refs(
        get_lib().wtpu_vp8l_optimal_refs, argb, width, CHAIN_DEPTH,
        cache_bits, *(cst.ctypes.data_as(f32p) for cst in costs),
        _ptr(lut_arr, _i32p), len(lut_arr))


# ---------------------------------------------------------------------------
# Distances, histograms and emission
# ---------------------------------------------------------------------------


def _build_dist_map() -> list[tuple[int, int]]:
    """The 120 near-distance codes' (dx, dy), in code order."""
    pairs = []
    for dy in range(8):
        lo = 1 if dy == 0 else -7
        for dx in range(lo, 9):
            pairs.append((dx, dy))
    pairs.sort(key=lambda p: (p[0] * p[0] + p[1] * p[1], abs(p[0]), p[0] < 0))
    return pairs


DIST_MAP = _build_dist_map()


def prefix_encode_vec(values: np.ndarray):
    """Vectorized prefix_encode → (codes, extra_bit_counts, extra_values)."""
    u = values.astype(np.int64) - 1
    small = u < 4
    # bit_length via frexp (exact for the 1..2^20 range used here).
    _, e = np.frexp(np.maximum(u, 1).astype(np.float64))
    bl = e.astype(np.int64)
    eb = np.maximum(bl - 2, 0)
    hi = u >= (3 << eb)
    code = np.where(small, u, 2 * eb + 2 + hi)
    nbits = np.where(small, 0, eb)
    base = np.where(hi, (3 << eb), (2 << eb))
    extra = np.where(small, 0, u - base)
    return code.astype(np.int64), nbits.astype(np.int64), extra.astype(np.int64)


def _build_dist_lut_array(width: int) -> np.ndarray:
    """dist → plane code (0 where the far-code d+120 applies)."""
    size = 7 * width + 9
    lut = np.zeros(size, np.int32)
    for code in range(120, 0, -1):
        dx, dy = DIST_MAP[code - 1]
        d = dy * width + dx
        if 1 <= d < size:
            lut[d] = code
    return lut


def _plane_codes(dists: np.ndarray, width: int) -> np.ndarray:
    """Copy distances → their distance symbols (plane code, prefix-coded)."""
    lut_arr = _build_dist_lut_array(width)
    ds = dists.astype(np.int64)
    near = lut_arr[np.minimum(ds, len(lut_arr) - 1)]
    planes = np.where((ds < len(lut_arr)) & (near > 0), near, ds + 120)
    return prefix_encode_vec(planes)[0]


def _build_histograms(refs: RefStream, width: int,
                      cache_bits: int = 0) -> list[np.ndarray]:
    cache_size = (1 << cache_bits) if cache_bits else 0
    green = np.zeros(NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size, np.int64)
    red = np.zeros(256, np.int64)
    blue = np.zeros(256, np.int64)
    alpha = np.zeros(256, np.int64)
    dist = np.zeros(NUM_DISTANCE_CODES, np.int64)

    lits = refs.argb[refs.ops == 0]
    if len(lits):
        green[:256] += np.bincount((lits >> 8) & 0xFF, minlength=256)[:256]
        red += np.bincount((lits >> 16) & 0xFF, minlength=256)[:256]
        blue += np.bincount(lits & 0xFF, minlength=256)[:256]
        alpha += np.bincount((lits >> 24) & 0xFF, minlength=256)[:256]
    cache_mask = refs.ops == 2
    if cache_mask.any():
        idxs = refs.lengths[cache_mask]
        green[280:] += np.bincount(idxs, minlength=cache_size)[:cache_size]
    copies = refs.ops == 1
    if copies.any():
        lcodes, _, _ = prefix_encode_vec(refs.lengths[copies])
        green[NUM_LITERAL_CODES : NUM_LITERAL_CODES + NUM_LENGTH_CODES] += (
            np.bincount(lcodes, minlength=NUM_LENGTH_CODES)[:NUM_LENGTH_CODES]
        )
        dcodes = _plane_codes(refs.dists[copies], width)
        dist += np.bincount(dcodes, minlength=NUM_DISTANCE_CODES)[:NUM_DISTANCE_CODES]
    return [green, red, blue, alpha, dist]


def _refs_args(refs: RefStream):
    return [np.ascontiguousarray(refs.ops, np.uint8),
            np.ascontiguousarray(refs.argb, np.uint32),
            np.ascontiguousarray(refs.lengths, np.int32),
            np.ascontiguousarray(refs.dists, np.int32)]


def _emit_native(fn, bw: BitWriter, refs: RefStream, codes, width: int,
                 group_idx=None) -> None:
    """Native emission of the op stream, continuing ``bw``'s state:
    ``wtpu_vp8l_emit`` with one set of 5 codes, or
    ``wtpu_vp8l_emit_grouped`` with ``group_idx`` (one group per op) and
    5 codes per group."""
    offsets = np.zeros(len(codes), np.int32)
    offsets[1:] = np.cumsum([len(c.bits) for c in codes])[:-1]
    bits_all = np.ascontiguousarray(
        np.concatenate([c.bits.astype(np.uint16) for c in codes]))
    lens_all = np.ascontiguousarray(
        np.concatenate([c.lengths.astype(np.uint8) for c in codes]))
    lut_arr = _build_dist_lut_array(width)
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64(0)
    acc_out = ctypes.c_uint32(0)
    used_out = ctypes.c_int(0)
    ops, argbs, lens, dists = _refs_args(refs)
    refs_p = [_ptr(ops, _u8p), _ptr(argbs, _u32p), _ptr(lens, _i32p),
              _ptr(dists, _i32p)]
    code_p = [_ptr(bits_all, _u16p), _ptr(lens_all, _u8p),
              _ptr(offsets, _i32p)]
    if group_idx is None:
        head = refs_p + [len(ops), width] + code_p
    else:
        gidx = np.ascontiguousarray(group_idx, np.int32)
        head = (refs_p + [_ptr(gidx, _i32p), len(ops), width] + code_p
                + [len(codes) // 5])
    fn(*head, _ptr(lut_arr, _i32p), len(lut_arr),
       bw._acc & 0xFFFFFFFF, bw._used,
       ctypes.byref(out_p), ctypes.byref(out_n),
       ctypes.byref(acc_out), ctypes.byref(used_out))
    data = ctypes.string_at(out_p, out_n.value)
    get_lib().wtpu_free(out_p)
    bw._buf.extend(data)
    bw._acc = int(acc_out.value)
    bw._used = int(used_out.value)


def _entropy_bits(hists) -> float:
    total_bits = 0.0
    for h in hists:
        tot = int(h.sum())
        if tot == 0:
            continue
        nz = h[h > 0].astype(np.float64)
        total_bits += float((nz * (np.log2(tot) - _log2f(nz + 1e-9))).sum())
        # Rough header cost per used symbol.
        total_bits += 6.0 * len(nz)
    return total_bits


# ---------------------------------------------------------------------------
# Tile histograms and their clustering (the meta-prefix image)
# ---------------------------------------------------------------------------


def _op_start_positions(refs: RefStream) -> np.ndarray:
    counts = np.where(refs.ops == 1, refs.lengths, 1).astype(np.int64)
    starts = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return starts


def _green_symbols(refs: RefStream) -> np.ndarray:
    """Vectorized green-tree symbol per op."""
    syms = np.zeros(len(refs.ops), np.int64)
    lit = refs.ops == 0
    syms[lit] = (refs.argb[lit] >> 8) & 0xFF
    cp = refs.ops == 1
    if cp.any():
        lcodes, _, _ = prefix_encode_vec(refs.lengths[cp])
        syms[cp] = NUM_LITERAL_CODES + lcodes
    ca = refs.ops == 2
    syms[ca] = NUM_LITERAL_CODES + NUM_LENGTH_CODES + refs.lengths[ca]
    return syms


def _tile_histograms(refs: RefStream, width: int, height: int, bits: int,
                     cache_bits: int):
    """Per-tile 5-tree histograms as one (T, S) matrix + tree slices."""
    cache_size = (1 << cache_bits) if cache_bits else 0
    g_n = NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size
    slices = [
        (0, g_n),
        (g_n, g_n + 256),
        (g_n + 256, g_n + 512),
        (g_n + 512, g_n + 768),
        (g_n + 768, g_n + 768 + NUM_DISTANCE_CODES),
    ]
    S = slices[-1][1]
    tw = tnp.subsample_size(width, bits)
    th = tnp.subsample_size(height, bits)
    T = tw * th
    starts = _op_start_positions(refs)
    tile = ((starts // width) >> bits) * tw + ((starts % width) >> bits)
    H = np.zeros((T, S), np.int64)
    np.add.at(H, (tile, _green_symbols(refs)), 1)
    lit = refs.ops == 0
    if lit.any():
        lits = refs.argb[lit]
        tl = tile[lit]
        np.add.at(H, (tl, g_n + ((lits >> 16) & 0xFF)), 1)
        np.add.at(H, (tl, g_n + 256 + (lits & 0xFF)), 1)
        np.add.at(H, (tl, g_n + 512 + ((lits >> 24) & 0xFF)), 1)
    cp = refs.ops == 1
    if cp.any():
        dcodes = _plane_codes(refs.dists[cp], width)
        np.add.at(H, (tile[cp], g_n + 768 + dcodes), 1)
    return H, slices, tile, tw, th


def _entropy_of_rows(H: np.ndarray, slices) -> np.ndarray:
    """Shannon bits per histogram row (summed over the 5 trees)."""
    out = np.zeros(len(H), np.float64)
    for a, b in slices:
        sub = H[:, a:b].astype(np.float64)
        tot = sub.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = sub / np.maximum(tot[:, None], 1)
            bits = -np.where(sub > 0, sub * _log2f(p + 1e-12), 0.0)
        out += bits.sum(axis=1)
    return out


GROUP_HEADER_BITS = 1500.0   # approx cost of one extra group's 5 codes


def _tree_entropy(H: np.ndarray, a: int, b: int) -> np.ndarray:
    """Shannon bits of one tree's sub-histogram per row."""
    sub = H[:, a:b].astype(np.float64)
    tot = sub.sum(axis=1)
    n_log_n = tot * _log2f(tot + 1e-9)
    return n_log_n - (sub * _log2f(sub + 1e-9)).sum(axis=1)


def _stochastic_merge(rows, cost, group_of, alive, slices,
                      down_to: int, seed: int = 7):
    """Stochastic pair merging: sample random live pairs, evaluate their
    savings at once, apply the best beneficial merge; give up after a
    streak of fruitless rounds.  Reduces many groups to a size the exact
    greedy stage can afford (O(G²))."""
    rng = np.random.default_rng(seed)
    fails = 0
    while int(alive.sum()) > down_to and fails < 8:
        live = np.flatnonzero(alive)
        n = len(live)
        if n <= 1:
            break
        k = min(max(16, 4 * int(np.sqrt(n))), n * (n - 1) // 2)
        ii = rng.integers(0, n, k)
        jj = (ii + 1 + rng.integers(0, n - 1, k)) % n
        i_idx, j_idx = live[ii], live[jj]
        merged = rows[i_idx] + rows[j_idx]
        ent = _entropy_of_rows(merged, slices)
        sav = cost[i_idx] + cost[j_idx] - ent
        b = int(np.argmax(sav))
        # A merge removes one group header; accept anything cheaper
        # than that (matches the greedy stage's stop criterion).
        if sav[b] > -GROUP_HEADER_BITS or int(alive.sum()) > 4 * down_to:
            i, j = int(i_idx[b]), int(j_idx[b])
            rows[i] += rows[j]
            cost[i] = float(_entropy_of_rows(rows[i][None, :], slices)[0])
            alive[j] = False
            group_of[group_of == j] = i
            fails = 0
        else:
            fails += 1


def _cluster_histograms(H: np.ndarray, slices, max_groups: int = 256,
                        refine_iters: int = 2):
    """Tile-histogram clustering → (group_map, merged_rows): entropy-bin
    preclustering, stochastic pair merging down to a greedy-affordable
    count, exact greedy merging with incrementally kept savings (stopping
    when the best merge loses more than a group's header), then
    reassignment of every tile to the group that codes it cheapest."""
    T = len(H)
    if T <= 1:
        return np.zeros(T, np.int32), [H[i] for i in range(T)]
    H = H.astype(np.int64)

    # --- Stage 1: precluster by discretized entropy signature. ---
    levels = 4 if T <= 256 else 6
    comps = (slices[0], slices[1], slices[2]) + (
        (slices[4],) if T > 256 and len(slices) > 4 else ())
    sig = []
    for a, b in comps:
        e = _tree_entropy(H, a, b)
        hi = e.max()
        q = np.minimum((e / max(hi, 1e-9) * levels).astype(np.int64),
                       levels - 1)
        sig.append(q)
    bin_id = sig[0]
    for s in sig[1:]:
        bin_id = bin_id * levels + s
    uniq, bin_of = np.unique(bin_id, return_inverse=True)
    G = len(uniq)
    rows = np.zeros((G, H.shape[1]), np.int64)
    np.add.at(rows, bin_of, H)
    group_of = bin_of.astype(np.int64)

    cost = _entropy_of_rows(rows, slices)

    # --- Stage 2: stochastic merge while the pair matrix is too big. ---
    if G > 96:
        alive0 = np.ones(G, bool)
        _stochastic_merge(rows, cost, group_of, alive0, slices, down_to=96)
        live_idx = np.flatnonzero(alive0)
        remap = np.full(G, -1, np.int64)
        remap[live_idx] = np.arange(len(live_idx))
        group_of = remap[group_of]
        rows = rows[live_idx].copy()
        cost = cost[live_idx]
        G = len(live_idx)

    # --- Stage 3: exact greedy merging with incremental savings. ---

    def pair_savings(i, rows, cost, alive_mask):
        merged = rows[i][None, :] + rows
        ent = _entropy_of_rows(merged, slices)
        s = cost[i] + cost - ent
        s[~alive_mask] = -np.inf
        s[i] = -np.inf
        return s

    alive = np.ones(G, bool)
    M = np.full((G, G), -np.inf)
    for i in range(G):
        M[i] = pair_savings(i, rows, cost, alive)
    while alive.sum() > 1:
        flat = np.argmax(M)
        i, j = divmod(int(flat), G)
        saving = M[i, j]
        n_alive = int(alive.sum())
        if saving <= -GROUP_HEADER_BITS and n_alive <= max_groups:
            break
        if saving <= 0 and n_alive <= 2:
            break
        rows[i] += rows[j]
        cost[i] = float(_entropy_of_rows(rows[i][None, :], slices)[0])
        alive[j] = False
        group_of[group_of == j] = i
        M[j, :] = -np.inf
        M[:, j] = -np.inf
        M[i, :] = pair_savings(i, rows, cost, alive)
        M[:, i] = M[i, :]

    live_idx = np.flatnonzero(alive)
    remap = np.full(G, -1, np.int64)
    remap[live_idx] = np.arange(len(live_idx))
    group_of = remap[group_of]
    rows = rows[live_idx]

    # --- Stage 4: refinement (cheapest-group reassignment). ---
    for _ in range(refine_iters):
        if len(rows) <= 1:
            break
        # log2 of per-tree code distributions, epsilon-smoothed.
        logp = np.empty(rows.shape, np.float64)
        for a, b in slices:
            sub = rows[:, a:b].astype(np.float64) + 0.04
            logp[:, a:b] = _log2f(sub / sub.sum(axis=1, keepdims=True) + 1e-12)
        bits = -(H @ logp.T)            # (T, G) cross-entropy bits
        new_assign = bits.argmin(axis=1)
        if np.array_equal(new_assign, group_of):
            break
        group_of = new_assign
        used, group_of = np.unique(group_of, return_inverse=True)
        rows = np.zeros((len(used), H.shape[1]), np.int64)
        np.add.at(rows, group_of, H)

    return group_of.astype(np.int32), [rows[i] for i in range(len(rows))]


# ---------------------------------------------------------------------------
# The spatially coded image
# ---------------------------------------------------------------------------


def _write_image_stream(bw: BitWriter, argb: np.ndarray, width: int) -> None:
    """Entropy-coded sub-image (no cache, no transforms): the
    meta-prefix image."""
    bw.put_bits(0, 1)  # no color cache
    refs = build_backward_refs(argb, width)
    hists = _build_histograms(refs, width)
    codes = [store_huffman_code(bw, build_code_lengths(h)) for h in hists]
    _emit_native(get_lib().wtpu_vp8l_emit, bw, refs, codes, width)


def _write_spatial_stream(bw: BitWriter, argb: np.ndarray,
                          width: int) -> None:
    """Top-level spatially-coded image body (after transform headers)."""
    height = argb.shape[0]
    # LZ77 variant trials: the hash-chain parse competes against the
    # run-length parse (distances 1 and width only, which wins on
    # vertical and horizontal fills).  Each is scored cache-less by its
    # total histogram entropy.
    scored = [(_entropy_bits(_build_histograms(r, width, 0)), r)
              for r in (build_refs_lz77(argb, width, 0),
                        build_backward_refs(argb, width))]
    refs = min(scored, key=lambda sr: sr[0])[1]
    # All cache sizes 0..10 scored by one native simulation over the
    # winning refs; the winner applied by an in-place literal→cache
    # rewrite, no re-parsing.
    cache_bits = _pick_cache_bits(refs, argb)
    if cache_bits:
        _apply_cache_native(refs, argb, cache_bits)
    hists = _build_histograms(refs, width, cache_bits)
    # The cost-model DP pays only when copies cover enough pixels to
    # re-arrange (graphics: a few whole-row copies).
    covered = int(refs.lengths[refs.ops == 1].sum())
    if covered * 20 >= argb.size:
        opt = build_refs_optimal(argb, width, cache_bits, seed=refs)
        opt_hists = _build_histograms(opt, width, cache_bits)
        if _entropy_bits(opt_hists) < _entropy_bits(hists):
            refs, hists = opt, opt_hists

    if cache_bits:
        bw.put_bits(1, 1)
        bw.put_bits(cache_bits, 4)
    else:
        bw.put_bits(0, 1)

    # Meta-prefix codes: tile histograms + clustering when the image is
    # big enough for spatial adaptivity to pay.
    use_meta = width * height >= (1 << 12)
    if use_meta:
        # Histogram tile bits scale with method (7 - method for a
        # non-palette image), then grow while the tile grid stays too
        # large to cluster (grid cap ~2600).
        bits = max(2, min(9, 7 - STREAM_METHOD))
        while bits < 9 and tnp.subsample_size(width, bits) * tnp.subsample_size(
            height, bits
        ) > 2600:
            bits += 1
        tw = tnp.subsample_size(width, bits)
        th = tnp.subsample_size(height, bits)
        if tw * th <= 1:
            use_meta = False
    if use_meta:
        H, slices, tile_of_op, tw, th = _tile_histograms(
            refs, width, height, bits, cache_bits
        )
        group_map, merged = _cluster_histograms(H, slices)
        num_groups = len(merged)
        # Only take the meta path when it actually wins the header bet.
        if num_groups > 1:
            est_meta = (
                float(_entropy_of_rows(np.stack(merged), slices).sum())
                + num_groups * GROUP_HEADER_BITS
                + tw * th * 4.0
            )
            est_single = _entropy_bits(hists) + GROUP_HEADER_BITS
            if est_meta >= est_single:
                num_groups = 1
        if num_groups > 1:
            bw.put_bits(1, 1)              # meta-prefix codes present
            bw.put_bits(bits - 2, 3)
            himg = (0xFF000000
                    | (group_map.astype(np.uint32).reshape(th, tw) << 8))
            _write_image_stream(bw, himg.astype(np.uint32), tw)
            codes_flat = []
            for row in merged:
                for a, b in slices:
                    codes_flat.append(
                        store_huffman_code(bw, build_code_lengths(row[a:b]))
                    )
            _emit_native(get_lib().wtpu_vp8l_emit_grouped, bw, refs,
                         codes_flat, width, group_idx=group_map[tile_of_op])
            return
    bw.put_bits(0, 1)  # no meta-prefix codes
    codes = [store_huffman_code(bw, build_code_lengths(h)) for h in hists]
    _emit_native(get_lib().wtpu_vp8l_emit, bw, refs, codes, width)


def encode_vp8l_alpha(plane: np.ndarray) -> bytes:
    """8-bit plane → headerless VP8L stream (values in green channel)."""
    argb = (0xFF000000 | (plane.astype(np.uint32) << 8)).astype(np.uint32)
    bw = BitWriter()
    bw.put_bits(0, 1)  # no transforms
    _write_spatial_stream(bw, argb, argb.shape[1])
    return bw.getvalue()


__all__ = ["build_backward_refs", "build_refs_lz77",
           "build_refs_optimal", "encode_vp8l_alpha", "prefix_encode",
           "store_huffman_code"]
