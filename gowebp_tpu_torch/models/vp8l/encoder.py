"""VP8L (WebP lossless) encoder.

``encode_vp8l`` (the lossless ``encode_rgba``) and ``encode_vp8l_alpha``
(the lossy encode's ALPH chunk).  The transforms: colour indexing with
a palette order trial, or the photo path's joint trial over
subtract-green, the per-tile predictor chooser at the method's tile
sizes (plus uniform and no-predictor candidates) and the cross-colour
fit, ranked by LZ77 + histogram entropy probes and, at high effort,
full scratch emissions.  The spatially coded image: backward references
(the native hash-chain, run-length, 2-D "box" and cost-model parses), a
colour cache, and either one set of five prefix codes or tile
histograms clustered into groups (the meta-prefix image).

Everything runs on the host (numpy and the native layer,
entropy/native/*.cpp, whose failed build raises) except the predictor
chooser of large images: ``_choose_predictors_auto`` sends an image of
1 MP or more on a CUDA device, or any image when
``GOWEBP_TPU_VP8L_ANALYSIS=1``, to ``ops/lossless.py``
``predictor_search_entropy`` (the card's kernel, or its plain version on
the CPU).  Written from the lossless bitstream spec.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ...constants import (CODE_LENGTH_CODE_ORDER, NUM_CODE_LENGTH_CODES,
                          NUM_DISTANCE_CODES, NUM_LENGTH_CODES,
                          NUM_LITERAL_CODES, VP8L_SIGNATURE)
from ...entropy.bitio import BitWriter
from ...entropy.huffman import build_code_lengths, canonical_codes
from ...entropy.native_loader import get_lib
from ...errors import EncodeError
from . import transforms_np as tnp

_INV_LN2 = 1.0 / np.log(2.0)

# Images of this many pixels or more take the device predictor chooser
# on a CUDA device; the switch sends every image there.
DEVICE_CHOOSER_PIXELS = 1 << 20
ANALYSIS_SWITCH = "GOWEBP_TPU_VP8L_ANALYSIS"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
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


def _chain_depth(quality: int) -> int:
    """The hash-chain walk budget at ``quality``."""
    return 8 + quality // 5


def build_refs_lz77(argb: np.ndarray, width: int, quality: int,
                    cache_bits: int) -> RefStream:
    """Native hash-chain LZ77 (+ colour cache)."""
    return _native_refs(get_lib().wtpu_vp8l_hashchain_refs, argb, width,
                        _chain_depth(quality), cache_bits)


def _greedy_refs_from_best(flat: np.ndarray, best_len: np.ndarray,
                           best_dist: np.ndarray) -> RefStream:
    """Greedy left-to-right parse given per-position best matches.

    Literal stretches between viable copies are emitted in bulk, so the
    Python loop runs once per op-run, not per pixel.
    """
    n = len(flat)
    cand = np.flatnonzero(best_len >= MIN_COPY_LEN)
    ops_l, argb_l, len_l, dist_l = [], [], [], []
    i = 0
    while i < n:
        ci = np.searchsorted(cand, i)
        j = int(cand[ci]) if ci < len(cand) else n
        if j > i:
            seg = flat[i:j]
            ops_l.append(np.zeros(j - i, np.uint8))
            argb_l.append(seg.astype(np.uint32))
            len_l.append(np.ones(j - i, np.int32))
            dist_l.append(np.zeros(j - i, np.int32))
            i = j
            continue
        length = min(int(best_len[i]), MAX_COPY_LEN)
        ops_l.append(np.ones(1, np.uint8))
        argb_l.append(np.zeros(1, np.uint32))
        len_l.append(np.array([length], np.int32))
        dist_l.append(np.array([int(best_dist[i])], np.int32))
        i += length
    return RefStream(
        np.concatenate(ops_l) if ops_l else np.zeros(0, np.uint8),
        np.concatenate(argb_l) if argb_l else np.zeros(0, np.uint32),
        np.concatenate(len_l) if len_l else np.zeros(0, np.int32),
        np.concatenate(dist_l) if dist_l else np.zeros(0, np.int32),
    )


def _forward_run_lengths(eq: np.ndarray) -> np.ndarray:
    """run[i] = number of consecutive True starting at i."""
    n = len(eq)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n)
    # For each i, distance to the next False at or after i.
    false_pos = np.flatnonzero(~eq)
    next_false = np.full(n, n, np.int64)
    if len(false_pos):
        ins = np.searchsorted(false_pos, idx, side="left")
        valid = ins < len(false_pos)
        next_false[valid] = false_pos[ins[valid]]
    return next_false - idx


def build_refs_box(argb: np.ndarray, width: int) -> RefStream:
    """2-D locality ("box") LZ77: matches only at the 120 plane-coded
    neighbour distances, the variant that wins on hard-edged, palettized
    graphics, where short 2-D distances get the cheap single-symbol
    distance codes (libwebp's BackwardReferencesLz77Box)."""
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    n = flat.size
    best_len = np.zeros(n, np.int32)
    best_dist = np.zeros(n, np.int32)
    dists = sorted({max(1, dy * width + dx) for dx, dy in DIST_MAP
                    if 1 <= dy * width + dx < n})
    eq = np.empty(n, bool)
    for d in dists:
        eq[:d] = False
        np.equal(flat[d:], flat[:-d], out=eq[d:])
        rl = _forward_run_lengths(eq).astype(np.int32)
        better = rl > best_len
        np.copyto(best_len, rl, where=better)
        np.copyto(best_dist, np.int32(d), where=better)
    return _greedy_refs_from_best(flat, best_len, best_dist)


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


def build_refs_optimal(argb: np.ndarray, width: int, quality: int,
                       cache_bits: int, seed: RefStream) -> RefStream:
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
        get_lib().wtpu_vp8l_optimal_refs, argb, width, _chain_depth(quality),
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


def _write_spatial_stream(bw: BitWriter, argb: np.ndarray, width: int,
                          quality: int = 75, stats=None, method: int = 4,
                          is_palette: bool = False) -> None:
    """Top-level spatially-coded image body (after transform headers)."""
    height = argb.shape[0]
    if quality >= 20:
        # LZ77 variant trials: the hash-chain parse competes against the
        # run-length parse (distances 1 and width only, which wins on
        # vertical and horizontal fills) from quality 25, and palette
        # streams also try the 2-D "box" parse.  Each is scored
        # cache-less by its total histogram entropy.
        cands = [build_refs_lz77(argb, width, quality, 0)]
        if quality >= 25:
            cands.append(build_backward_refs(argb, width))
        if is_palette and method >= 2:
            cands.append(build_refs_box(argb, width))
        scored = [(_entropy_bits(_build_histograms(r, width, 0)), r)
                  for r in cands]
        refs = min(scored, key=lambda sr: sr[0])[1]
        # All cache sizes 0..10 scored by one native simulation over the
        # winning refs; the winner applied by an in-place literal→cache
        # rewrite, no re-parsing.
        cache_bits = _pick_cache_bits(refs, argb)
        if cache_bits:
            _apply_cache_native(refs, argb, cache_bits)
        hists = _build_histograms(refs, width, cache_bits)
        # The cost-model DP pays only when copies cover enough pixels to
        # re-arrange (graphics: a few whole-row copies); from quality 90
        # it always runs.
        covered = int(refs.lengths[refs.ops == 1].sum())
        if quality >= 25 and (quality >= 90 or covered * 20 >= argb.size):
            opt = build_refs_optimal(argb, width, quality, cache_bits,
                                     seed=refs)
            opt_hists = _build_histograms(opt, width, cache_bits)
            if _entropy_bits(opt_hists) < _entropy_bits(hists):
                refs, hists = opt, opt_hists
    else:
        refs = build_backward_refs(argb, width)
        cache_bits = 0
        hists = _build_histograms(refs, width, 0)

    if cache_bits:
        bw.put_bits(1, 1)
        bw.put_bits(cache_bits, 4)
    else:
        bw.put_bits(0, 1)
    if stats is not None:
        stats.cache_bits = cache_bits

    # Meta-prefix codes: tile histograms + clustering when the image is
    # big enough for spatial adaptivity to pay.
    use_meta = quality >= 30 and width * height >= (1 << 12)
    if use_meta:
        # Histogram tile bits scale with method and content class
        # ((palette ? 9 : 7) - method), then grow while the tile grid
        # stays too large to cluster (grid cap ~2600).
        bits = max(2, min(9, (9 if is_palette else 7) - method))
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
            if stats is not None:
                stats.num_huffman_groups = num_groups
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


# ---------------------------------------------------------------------------
# Transforms (encoder side)
# ---------------------------------------------------------------------------


def _sub_pixels_vec(x, p):
    """Per-byte (x - p) mod 256 of packed ARGB."""
    lo = ((x | 0x01000100) - (p & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) | 0x01000100) - ((p >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return (lo | (hi << 8)).astype(np.uint32)


def _choose_predictors_auto(argb: np.ndarray, bits: int, refine_iters: int,
                            row_step: int, device) -> np.ndarray:
    """The per-tile predictor chooser, on ``device`` for large images.

    An image of DEVICE_CHOOSER_PIXELS or more on a CUDA device, or any
    image when $GOWEBP_TPU_VP8L_ANALYSIS is "1" (read at each call), goes
    to ``ops/lossless.py`` ``predictor_search_entropy``: the kernel on
    the card, its plain version on the CPU.  It scores every row
    (``row_step`` throttles the host chooser only) and may pick another
    mode than the host chooser on a near tie.  A kernel that fails to
    build or launch raises.  Every other call runs the host chooser.
    Returns the (th, tw) mode image as ARGB pixels (mode in green)."""
    force = os.environ.get(ANALYSIS_SWITCH) == "1"
    big = argb.shape[0] * argb.shape[1] >= DEVICE_CHOOSER_PIXELS
    if force or (big and device.type == "cuda"):
        modes = _device_modes(argb, bits, refine_iters, device)
        return (0xFF000000 | (modes.astype(np.uint32) << 8)).astype(np.uint32)
    return _choose_predictors(argb, bits, refine_iters=refine_iters,
                              row_step=row_step)


def _device_modes(argb: np.ndarray, bits: int, refine_iters: int,
                  device) -> np.ndarray:
    """``predictor_search_entropy`` of ``argb`` on ``device`` (upload,
    the chooser, download) → the (th, tw) int32 mode map."""
    import torch

    from ...ops.lossless import predictor_search_entropy

    words = np.ascontiguousarray(argb, np.uint32).view(np.int32)
    modes = predictor_search_entropy(torch.from_numpy(words).to(device),
                                     bits, refine_iters)
    return modes.cpu().numpy()


def _choose_predictors(argb: np.ndarray, bits: int, refine_iters: int = 4,
                       row_step: int = 1) -> np.ndarray:
    """Per-tile best predictor by residual-histogram entropy (the native
    host chooser, ``wtpu_vp8l_choose_predictors``).

    The cost per tile is the Shannon entropy of the four per-channel
    residual-byte histograms plus a small magnitude bias (0.04 x the
    byte's distance from 0 mod 256): entropy prefers a *constant*
    residual (e.g. TOP on a vertical gradient) over a mostly-zero but
    ragged one, which also LZ77-compresses far better.  Then
    ``refine_iters`` rounds re-pick each tile by its cross-entropy under
    the global residual distribution of the current picks plus the mode
    symbol's own cost, since all tiles share the prefix codes.
    """
    h, w = argb.shape
    th = tnp.subsample_size(h, bits)
    tw = tnp.subsample_size(w, bits)
    flat = np.ascontiguousarray(argb, np.uint32)
    out = np.empty(th * tw, np.uint8)
    get_lib().wtpu_vp8l_choose_predictors(_ptr(flat, _u32p), h, w, bits,
                                          refine_iters, row_step,
                                          _ptr(out, _u8p))
    modes = out.reshape(th, tw).astype(np.uint32)
    return (0xFF000000 | (modes << 8)).astype(np.uint32)


def _apply_predictor_transform(argb: np.ndarray, bits: int,
                               mode_img: np.ndarray) -> np.ndarray:
    """Residual = pixel - pred(mode of its tile), with the decoder's edge
    rules (native)."""
    h, w = argb.shape
    flat = np.ascontiguousarray(argb, np.uint32)
    modes = np.ascontiguousarray(mode_img, np.uint32)
    out = np.empty((h, w), np.uint32)
    get_lib().wtpu_vp8l_predictor_residual(_ptr(flat, _u32p), h, w, bits,
                                           _ptr(modes, _u32p),
                                           modes.shape[1], _ptr(out, _u32p))
    return out


def _probe_rows(argb: np.ndarray) -> np.ndarray:
    """Row subsample for transform-trial cost probes.

    Trial scoring only needs the *relative* ordering of candidates, so on
    tall images three 128-row slabs (top/middle/bottom) stand in for the
    full image; matches within a slab are intact, dist-width matches
    cross slab seams harmlessly (same estimate noise for every
    candidate).  ≤400-row images are probed exactly.
    """
    h = argb.shape[0]
    if h <= 400:
        return argb
    slabs = [argb[r0:r0 + 128]
             for r0 in (0, (h - 128) * 2 // 5, (h - 128) * 4 // 5)]
    return np.ascontiguousarray(np.concatenate(slabs, axis=0))


def _refs_cost_bits(argb: np.ndarray, width: int, quality: int) -> float:
    """Estimated body cost: LZ77 refs + histogram entropy (no emission).

    Unlike raw literal entropy this accounts for LZ77: on highly
    repetitive residuals the copy stream dominates, and a transform that
    lowers literal entropy may save nothing in the actual bitstream.
    """
    refs = build_refs_lz77(argb, width, quality, 0)
    return _entropy_bits(_build_histograms(refs, width, 0))


def _choose_cross_color_scored(
        argb: np.ndarray, bits: int, row_step: int = 1
) -> tuple[np.ndarray | None, float]:
    """Per-tile g→r / g→b / r→b multipliers by entropy descent (native
    ``wtpu_vp8l_cross_color_fit``).

    Returns (transform_image | None, gain_bits): the summed cost saved
    against the zero transform, which lets the caller decide cross-colour
    on or off without a trial probe; None when every tile stays at 0.
    Each 3.5-bit fixed-point multiplier is found by a coarse-to-fine
    descent (deltas 32..1; the blue pair moves along 8 joint
    directions) on the Shannon bits of the tile's residual histogram
    minus a near-zero concentration bonus.  ``row_step`` > 1 subsamples
    the scoring rows (the transform itself stays exact).
    """
    h, w = argb.shape
    th = tnp.subsample_size(h, bits)
    tw = tnp.subsample_size(w, bits)
    flat = np.ascontiguousarray(argb, np.uint32)
    out = np.empty(th * tw * 3, np.int8)
    gain_c = ctypes.c_double(0.0)
    get_lib().wtpu_vp8l_cross_color_fit(_ptr(flat, _u32p), h, w, bits,
                                        row_step, _ptr(out, _i8p),
                                        ctypes.byref(gain_c))
    mults = out.reshape(th, tw, 3).astype(np.int64)
    g2r, g2b, r2b = mults[..., 0], mults[..., 1], mults[..., 2]
    if not (g2r.any() or g2b.any() or r2b.any()):
        return None, 0.0
    return (
        0xFF000000
        | ((r2b & 0xFF).astype(np.uint32) << 16)
        | ((g2b & 0xFF).astype(np.uint32) << 8)
        | (g2r & 0xFF).astype(np.uint32)
    ).astype(np.uint32), float(gain_c.value)


def _bits_entropy(h: np.ndarray) -> float:
    tot = float(h.sum())
    if tot <= 0:
        return 0.0
    p = h[h > 0].astype(np.float64) / tot
    return float(-(p * np.log2(p)).sum() * tot)


def analyze_entropy(argb: np.ndarray, row_step: int = 1) -> str:
    """One-pass entropy-mode analysis (libwebp's AnalyzeEntropy): score
    direct / spatial / subgreen / spatial-subgreen from per-channel
    histograms of the raw pixels and their left-neighbour deltas, all
    gathered in a single sweep.

    Picks the transform set directly at low effort (method ≤ 2) instead
    of running trial encodes.  ``row_step`` subsamples the scored rows.
    """
    if row_step > 1:
        argb = argb[::row_step]
    flat = argb.reshape(-1).astype(np.uint32)
    prev = np.concatenate([flat[:1], flat[:-1]])
    diff = _sub_pixels_vec(flat, prev)

    def chans(v):
        return ((v >> 24) & 0xFF, (v >> 16) & 0xFF,
                (v >> 8) & 0xFF, v & 0xFF)

    def ent4(a, r, g, b):
        return sum(_bits_entropy(np.bincount(x, minlength=256))
                   for x in (a, r, g, b))

    a, r, g, b = chans(flat)
    da, dr, dg, db = chans(diff)
    direct = ent4(a, r, g, b)
    spatial = ent4(da, dr, dg, db)
    subgreen = ent4(a, (r - g) & 0xFF, g, (b - g) & 0xFF)
    sg_flat = ((flat & 0xFF00FF00)
               | (((r - g) & 0xFF) << 16) | ((b - g) & 0xFF))
    sgd = _sub_pixels_vec(sg_flat.astype(np.uint32), np.concatenate(
        [sg_flat[:1], sg_flat[:-1]]).astype(np.uint32))
    sa, sr, sgc, sb = chans(sgd)
    spatial_subgreen = ent4(sa, sr, sgc, sb)
    # Spatial modes pay for the predictor mode image; sub-green is a
    # 2-bit signal.
    n = flat.size
    overhead = max(64.0, n / 256.0)
    scores = {
        "direct": direct,
        "subgreen": subgreen + 2,
        "spatial": spatial + overhead,
        "spatial-subgreen": spatial_subgreen + overhead + 2,
    }
    return min(scores, key=scores.get)


def _crunch_params(quality: int, method: int, hint: int = 0) -> dict:
    """Method/quality → trial breadth for the photo path (libwebp's
    CrunchConfig matrix): one cheap config at low methods, the full set
    at method 6 / q90+.  ``rescore`` is how many top probe-ranked
    candidates get a full scratch emission."""
    if method >= 6 and quality >= 90:
        bit_cands: tuple = (3, 4, 5)
    elif method >= 5 and quality >= 50:
        bit_cands = (4, 5)
    elif method <= 2:
        # Low effort: coarse tiles, 4x fewer to score.
        bit_cands = (5,)
    else:
        bit_cands = (4,)
    # Both subtract-green settings from method 3 up: the single most
    # valuable trial, for one extra probe.
    sg_opts = ((True, False) if quality >= 75 and method >= 3
               else (True,))
    refine_iters = 4 if method >= 6 and quality >= 90 else 2
    if quality >= 75 and method >= 5:
        rescore = 4 if method >= 6 else 2
    else:
        rescore = 0
    if hint == 3:   # ImageHint.GRAPH: full-emission rescoring always
        rescore = max(rescore, 2)
        sg_opts = (True, False)
    return dict(bit_cands=bit_cands, sg_opts=sg_opts,
                refine_iters=refine_iters, rescore=rescore)


def _encode_stream_photo(bw: BitWriter, argb: np.ndarray, quality: int,
                         method: int, stats, hint: int, device) -> None:
    w = argb.shape[1]
    h = argb.shape[0]

    analysis_mode = None
    use_predictor = None
    if method <= 2 and quality >= 10:
        # Low effort: the one-pass analysis picks the transform set
        # outright, no trial encodes.
        analysis_mode = analyze_entropy(
            argb, row_step=2 if h * w >= (1 << 17) else 1)
        use_predictor = analysis_mode in ("spatial", "spatial-subgreen")
    if use_predictor is None:
        use_predictor = quality >= 10
    emitted = None
    if use_predictor:
        # Joint trial over {subtract-green} x {predictor candidates} x
        # {cross-colour}, scored by LZ77 + histogram entropy plus the
        # transform images' own streams.  Predictor candidates: the
        # per-tile entropy chooser at the method's tile sizes, plus
        # uniform TOP and LEFT and no predictor at all (mod-256 residuals
        # of one mode are periodic on synthetic gradients, which the
        # per-tile metric cannot see and LZ77 can).
        crunch = _crunch_params(quality, method, hint=hint)
        bit_cands = crunch["bit_cands"]
        sg_opts = crunch["sg_opts"]
        if analysis_mode is not None:
            sg_opts = ((analysis_mode == "spatial-subgreen"),)
        iters = crunch["refine_iters"]
        use_cross = quality >= 50
        cc_bits = 5 if method <= 2 else 4
        # Low methods score the choosers on every 2nd row (the
        # transforms stay exact).
        speed_step = 2 if method <= 2 else 1
        # The uniform / no-predictor extras run under one subtract-green
        # setting, the one the one-pass analysis ranks first.
        sg_extra = True
        if len(sg_opts) > 1 and quality >= 50 and method >= 3:
            am = analysis_mode or analyze_entropy(
                argb, row_step=2 if h * w >= (1 << 17) else 1)
            sg_extra = am in ("subgreen", "spatial-subgreen")
        # The per-(sg, bits) choosers are independent, and the native one
        # releases the GIL: up to 4 run at once.
        sg_bases = {sg: (tnp.subtract_green_forward(argb) if sg else argb)
                    for sg in sg_opts}
        chooser_keys = [(sg, bits) for sg in sg_opts for bits in bit_cands]

        def choose(key):
            return _choose_predictors_auto(sg_bases[key[0]], key[1], iters,
                                           speed_step, device)

        if len(chooser_keys) > 1:
            with ThreadPoolExecutor(min(4, len(chooser_keys))) as ex:
                chosen = dict(zip(chooser_keys, ex.map(choose, chooser_keys)))
        else:
            chosen = {k: choose(k) for k in chooser_keys}

        jobs = []
        for sg in sg_opts:
            base = sg_bases[sg]
            cand_imgs = [(bits, chosen[(sg, bits)]) for bits in bit_cands]
            if quality >= 50 and method >= 3 and (sg == sg_extra
                                                  or len(sg_opts) == 1):
                th5 = tnp.subsample_size(h, 5)
                tw5 = tnp.subsample_size(w, 5)
                for um in (2, 1):      # uniform TOP, uniform LEFT
                    uni = np.full((th5, tw5),
                                  0xFF000000 | (um << 8), np.uint32)
                    cand_imgs.append((5, uni))
                # No predictor (direct / subtract-green only): periodic
                # content LZ77-compresses better unfiltered.
                cand_imgs.append((0, None))
            jobs.extend((sg, base, bits, mode_img)
                        for bits, mode_img in cand_imgs)

        # With one job and no rescore stage the probes decide nothing.
        fast_single = len(jobs) == 1 and crunch["rescore"] <= 1

        def _trial(job):
            sg, base, bits, mode_img = job
            if mode_img is None:       # direct / subtract-green-only
                res = base
                phdr = 0
            else:
                res = _apply_predictor_transform(base, bits, mode_img)
                scratch = BitWriter()
                _write_image_stream(scratch, mode_img, mode_img.shape[1])
                phdr = scratch.bit_count + 6   # + transform signal bits
            cc_img, cc_gain = (
                _choose_cross_color_scored(res, cc_bits,
                                           row_step=speed_step)
                if use_cross else (None, 0.0))
            chdr = 0
            if cc_img is not None:
                s2 = BitWriter()
                _write_image_stream(s2, cc_img, cc_img.shape[1])
                chdr = s2.bit_count + 6
                # Decisive entropy-gain bands skip the cc-vs-none probe
                # pair; only the ambiguous middle still pays for it.
                if cc_gain <= chdr:
                    cc_img = None
                    chdr = 0
                elif not (fast_single or cc_gain >= 4 * chdr):
                    cc_res = tnp.color_transform_forward(
                        res, cc_img, cc_bits)
                    out = []
                    for cimg, cres, ch in ((None, res, 0),
                                           (cc_img, cc_res, chdr)):
                        cost = (_refs_cost_bits(_probe_rows(cres), w, 25)
                                + phdr + ch)
                        out.append((cost, sg, bits, mode_img, cimg, cres,
                                    phdr + ch))
                    return out
            cres = (tnp.color_transform_forward(res, cc_img, cc_bits)
                    if cc_img is not None else res)
            cost = 0.0 if fast_single else (
                _refs_cost_bits(_probe_rows(cres), w, 25) + phdr + chdr)
            return [(cost, sg, bits, mode_img, cc_img, cres, phdr + chdr)]

        # The probes are native (GIL released): trials run concurrently.
        if len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=min(len(jobs), 6)) as ex:
                results = list(ex.map(_trial, jobs))
        else:
            results = [_trial(job) for job in jobs]
        entries = [e for out in results for e in out]
        entries.sort(key=lambda e: e[0])
        if crunch["rescore"] > 1 and len(entries) > 1:
            # The probe ignores the colour cache and meta-prefix codes:
            # rescore the closest candidates with a full scratch emission
            # of the spatial stream (spliced below, not re-encoded), and
            # always give the best no-predictor candidates a slot (the
            # probe over-ranks predictor residuals on self-similar
            # content).
            pool = list(entries[: crunch["rescore"]])
            direct = [e for e in entries if e[3] is None]
            n_direct = len(direct) if h * w < (1 << 18) else 2
            ids = {id(e) for e in pool}
            pool.extend(e for e in direct[:n_direct]
                        if id(e) not in ids)
            rescored = []
            for e in pool:
                sbw = BitWriter()
                _write_spatial_stream(sbw, e[5], w, quality, method=method)
                rescored.append((sbw.bit_count + e[6], sbw, e))
            rescored.sort(key=lambda t: t[0])
            best = rescored[0][2]
            if stats is None:
                emitted = rescored[0][1]
        else:
            best = entries[0]
        _, use_sg, bits, mode_img, cc_img, work = best[:6]
        if use_sg:
            bw.put_bits(1, 1)
            bw.put_bits(2, 2)          # SUBTRACT_GREEN
        if mode_img is not None:
            bw.put_bits(1, 1)
            bw.put_bits(0, 2)          # PREDICTOR_TRANSFORM
            bw.put_bits(bits - 2, 3)
            _write_image_stream(bw, mode_img, mode_img.shape[1])
        else:
            use_predictor = False      # no predictor won the trial
        if cc_img is not None:
            bw.put_bits(1, 1)
            bw.put_bits(1, 2)          # COLOR_TRANSFORM
            bw.put_bits(cc_bits - 2, 3)
            _write_image_stream(bw, cc_img, cc_img.shape[1])
            if stats is not None:
                stats.transforms.append("cross-color")
    elif quality >= 50 and analysis_mode != "direct":
        # No predictor: subtract-green (unless the one-pass analysis
        # picked direct), then gated cross-colour.
        use_sg = True
        work = tnp.subtract_green_forward(argb)
        bw.put_bits(1, 1)
        bw.put_bits(2, 2)              # SUBTRACT_GREEN
        cc_bits = 4
        cc_img, cc_gain = _choose_cross_color_scored(
            work, cc_bits, row_step=2 if method <= 2 else 1)
        if cc_img is not None:
            scratch = BitWriter()
            _write_image_stream(scratch, cc_img, cc_img.shape[1])
            # the descent's own gain against the transform image's cost
            if cc_gain > scratch.bit_count + 6:
                bw.put_bits(1, 1)
                bw.put_bits(1, 2)      # COLOR_TRANSFORM
                bw.put_bits(cc_bits - 2, 3)
                _write_image_stream(bw, cc_img, cc_img.shape[1])
                work = tnp.color_transform_forward(work, cc_img, cc_bits)
                if stats is not None:
                    stats.transforms.append("cross-color")
    else:
        use_sg = True
        work = tnp.subtract_green_forward(argb)
        bw.put_bits(1, 1)
        bw.put_bits(2, 2)              # SUBTRACT_GREEN

    bw.put_bits(0, 1)  # end of transforms
    if stats is not None:
        if use_sg:
            stats.transforms.append("subtract-green")
        if use_predictor:
            stats.transforms.append("predictor")
    if use_predictor and emitted is not None:
        bw.append_writer(emitted)
    else:
        _write_spatial_stream(bw, work, w, quality, stats=stats,
                              method=method)


# ---------------------------------------------------------------------------
# Colour indexing (palette)
# ---------------------------------------------------------------------------


def rgba_to_argb(rgba: np.ndarray) -> np.ndarray:
    rgba = rgba.astype(np.uint32)
    return ((rgba[..., 3] << 24) | (rgba[..., 0] << 16)
            | (rgba[..., 1] << 8) | rgba[..., 2])


def _palette_of(argb: np.ndarray) -> np.ndarray | None:
    uniq = np.unique(argb)
    if len(uniq) <= 256:
        return uniq.astype(np.uint32)
    return None


def _pack_palette_indices(argb: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Map pixels → palette indices, bundled into green channel pixels."""
    h, w = argb.shape
    n = len(palette)
    order = np.argsort(palette)
    idx = order[np.searchsorted(palette, argb.reshape(-1), sorter=order)]
    idx = idx.reshape(h, w).astype(np.uint32)
    xbits = 0 if n > 16 else (1 if n > 4 else (2 if n > 2 else 3))
    if xbits == 0:
        packed = idx
    else:
        per = 1 << xbits
        bw_ = 8 >> xbits
        pw = tnp.subsample_size(w, xbits)
        padded = np.zeros((h, pw * per), np.uint32)
        padded[:, :w] = idx
        packed = np.zeros((h, pw), np.uint32)
        for k in range(per):
            packed |= padded[:, k::per] << (k * bw_)
    return (0xFF000000 | (packed << 8)).astype(np.uint32)


def _palette_orderings(palette: np.ndarray, argb: np.ndarray,
                       quality: int) -> list[np.ndarray]:
    """Candidate palette orders: lexicographic, luminance, and a greedy
    nearest-neighbour chain in RGB space from the most frequent colour
    (small index deltas between adjacent pixels compress better)."""
    cands = [palette]
    if quality < 40 or len(palette) <= 4:
        return cands
    a = (palette >> 24) & 0xFF
    r = (palette >> 16) & 0xFF
    g = (palette >> 8) & 0xFF
    b = palette & 0xFF
    lum = 299 * r + 587 * g + 114 * b + 1000 * a
    cands.append(palette[np.argsort(lum, kind="stable")])

    vals, counts = np.unique(argb, return_counts=True)
    freq = dict(zip(vals.tolist(), counts.tolist()))
    cols = np.stack([a, r, g, b], axis=1).astype(np.int64)
    n = len(palette)
    used = np.zeros(n, bool)
    cur = int(np.argmax([freq.get(int(p), 0) for p in palette]))
    order = [cur]
    used[cur] = True
    for _ in range(n - 1):
        d = np.abs(cols - cols[order[-1]]).sum(axis=1)
        d[used] = 1 << 30
        cur = int(np.argmin(d))
        order.append(cur)
        used[cur] = True
    cands.append(palette[np.array(order)])
    return cands


def _choose_palette_order(palette: np.ndarray, argb: np.ndarray,
                          quality: int, method: int) -> np.ndarray:
    cands = _palette_orderings(palette, argb, quality)
    if len(cands) == 1:
        return cands[0]
    best = None
    for cand in cands:
        packed = _pack_palette_indices(argb, cand)
        if method >= 6 and quality >= 90:
            # Brute force: every ordering gets a full scratch emission
            # (the probe cannot see cache, meta-prefix or LZ77-variant
            # interactions).
            sbw = BitWriter()
            _write_spatial_stream(sbw, packed, packed.shape[1], quality,
                                  method=method, is_palette=True)
            cost = float(sbw.bit_count)
        else:
            cost = _refs_cost_bits(packed, packed.shape[1], 25)
        if best is None or cost < best[0]:
            best = (cost, cand)
    return best[1]


def _sub_scalar(pixel: int, pred: int) -> int:
    out = 0
    for shift in (24, 16, 8, 0):
        out |= (((pixel >> shift) - (pred >> shift)) & 0xFF) << shift
    return out


def _encode_stream_palette(bw: BitWriter, argb: np.ndarray, palette,
                           quality: int, stats, method: int) -> None:
    palette = _choose_palette_order(palette, argb, quality, method)
    bw.put_bits(1, 1)
    bw.put_bits(3, 2)              # COLOR_INDEXING_TRANSFORM
    bw.put_bits(len(palette) - 1, 8)
    # Palette stored delta-coded as a (n,1) entropy image.
    deltas = np.zeros(len(palette), np.uint32)
    prev = 0
    for i, c in enumerate(palette):
        deltas[i] = _sub_scalar(int(c), prev)
        prev = int(c)
    _write_image_stream(bw, deltas.reshape(1, -1), len(palette))
    packed = _pack_palette_indices(argb, palette)
    bw.put_bits(0, 1)  # end of transforms
    if stats is not None:
        stats.palette_size = len(palette)
        stats.transforms.append("color-indexing")
    _write_spatial_stream(bw, packed, packed.shape[1], quality, stats=stats,
                          method=method, is_palette=True)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def encode_vp8l_stream(argb: np.ndarray, *, quality: int, method: int,
                       bw: BitWriter, stats, hint: int, device) -> BitWriter:
    """Encode the image-stream portion (after the 5-byte header).

    Paletted images take the colour-indexing path, but palettes of more
    than 64 colours at quality >= 50 also try the photo path and the
    smaller stream wins (ImageHint.PHOTO skips the palette for them).
    ``method`` scales the trial effort.
    """
    palette = _palette_of(argb)
    if palette is not None and hint == 2 and len(palette) > 64:
        palette = None
    if palette is not None:
        if len(palette) > 64 and quality >= 50:
            pal_bw = BitWriter()
            _encode_stream_palette(pal_bw, argb, palette, quality, None,
                                   method)
            photo_bw = BitWriter()
            _encode_stream_photo(photo_bw, argb, quality, method, None,
                                 hint, device)
            if stats is None:
                bw.append_writer(pal_bw if pal_bw.bit_count
                                 <= photo_bw.bit_count else photo_bw)
            elif pal_bw.bit_count <= photo_bw.bit_count:
                _encode_stream_palette(bw, argb, palette, quality, stats,
                                       method)
            else:
                _encode_stream_photo(bw, argb, quality, method, stats, hint,
                                     device)
        else:
            _encode_stream_palette(bw, argb, palette, quality, stats, method)
    else:
        _encode_stream_photo(bw, argb, quality, method, stats, hint, device)
    return bw


def encode_vp8l(rgba: np.ndarray, *, quality: int = 75, method: int = 4,
                stats=None, hint: int = 0, device=None) -> bytes:
    """(H, W, 3|4) uint8 RGBA → VP8L chunk payload.  ``device``: where
    the predictor chooser of a large image runs (None means CUDA and
    raises without it, before any work)."""
    from ...device import resolve_device

    dev = resolve_device(device)
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise EncodeError("expected (H, W, 3|4) array")
    if rgba.shape[2] == 3:
        rgba = np.concatenate(
            [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], axis=-1
        )
    h, w = rgba.shape[:2]
    if not (1 <= w <= 1 << 14 and 1 <= h <= 1 << 14):
        raise EncodeError("dimensions out of range")
    argb = rgba_to_argb(rgba)
    has_alpha = bool((rgba[..., 3] != 255).any())

    bw = BitWriter()
    bw.put_bits(VP8L_SIGNATURE, 8)
    bw.put_bits(w - 1, 14)
    bw.put_bits(h - 1, 14)
    bw.put_bits(1 if has_alpha else 0, 1)
    bw.put_bits(0, 3)  # version
    encode_vp8l_stream(argb, quality=quality, method=method, bw=bw,
                       stats=stats, hint=hint, device=dev)
    return bw.getvalue()


def encode_vp8l_alpha(plane: np.ndarray) -> bytes:
    """8-bit plane → headerless VP8L stream (values in green channel),
    at quality 75, method 4, with no transforms."""
    argb = (0xFF000000 | (plane.astype(np.uint32) << 8)).astype(np.uint32)
    bw = BitWriter()
    bw.put_bits(0, 1)  # no transforms
    _write_spatial_stream(bw, argb, argb.shape[1], 75)
    return bw.getvalue()


__all__ = ["build_backward_refs", "build_refs_box", "build_refs_lz77",
           "build_refs_optimal", "encode_vp8l", "encode_vp8l_alpha",
           "encode_vp8l_stream", "prefix_encode", "store_huffman_code"]
