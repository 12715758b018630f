"""The arithmetic the chooser kernel (gowebp_tpu_torch/ops/kernels/
vp8l_predictor.cu) relies on, modelled in numpy on ops/lossless.py's own
tables and held to the plain version ``predictor_search_entropy_plain``:

- stage 1 scores while it counts: each increment of a bin from ``old`` to
  ``old + k`` adds ``k bias(b) - (nlogn(old + k) - nlogn(old))``; in any
  order of single increments, of warp ballots on byte 0 or of groups of
  equal bins (up to 32 lanes), the sums equal the plain version's stage-1
  scores, and every partial sum stays under 2^58;
- two 16-bit counts share a word: the old count comes back from the word
  an atomic returns, up to 1,024, and never carries into its neighbour;
- a refinement round scores by per-pixel table lookups, which equal
  sum_b h_b q(b);
- the transposing butterfly that sums the 14 partials over a warp.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gowebp_tpu_torch.ops import lossless as L
from gowebp_tpu_torch.ops.kernels import vp8l_predictor as K
from gowebp_tpu_torch.utils.corpus import natural_image

TAB = K.stage1_kernel_table()
NLOGN = TAB[:L.MAX_COUNT + 1]
BIAS = TAB[L.MAX_COUNT + 1:L.MAX_COUNT + 1 + 256]
D1 = TAB[L.MAX_COUNT + 1 + 256:]
WARP = 32


def _words(h, w, seed, kind="photo"):
    if kind == "flat":
        img = np.full((h, w, 3), 77, np.uint8)
    else:
        img = natural_image(h, w, seed=seed)
    argb = ((255 << 24) | (img[..., 0].astype(np.uint32) << 16)
            | (img[..., 1].astype(np.uint32) << 8) | img[..., 2])
    return torch.from_numpy(argb.astype(np.uint32).view(np.int32))


def _mode_bins(x, bits):
    """(14, H*W, 4) int64 bins (c << 8 | byte) of every mode's residuals,
    and each pixel's tile, as the plain version forms them."""
    h, w = x.shape
    tw = (w + (1 << bits) - 1) >> bits
    words = L.to_words(x)
    tile = ((np.arange(h) >> bits)[:, None] * tw
            + (np.arange(w) >> bits)[None, :]).reshape(-1)
    bins = np.stack([
        ((L._sub_pixels(words, L.predict_plane(words, m)).numpy()
          .reshape(-1, 1) >> np.array([24, 16, 8, 0])) & 0xFF)
        + np.arange(4) * 256 for m in range(L.NUM_MODES)])
    return bins.astype(np.int64), tile


def _batches(bins, tile, scheme, rnd):
    """The increments of one mode, in an order and batching the kernel may
    apply them: (key = tile * 1024 + bin, k) in application order.  Pixels
    are dealt to warps of 32 lanes in a random order; each warp applies
    its channels in turn; within a warp step, ``single`` adds each lane on
    its own, ``ballot`` one batch of the lanes on byte 0 and the others on
    their own, ``match`` one batch a distinct bin, ``apart`` (the kernel's
    way) each lane on its own but byte 0 left out (the kernel counts it
    apart and scores it from its final count); the batches of a step
    land in a random order (atomics)."""
    npx = len(tile)
    order = list(range(npx))
    rnd.shuffle(order)
    keys, ks = [], []
    for w0 in range(0, npx, WARP):
        lanes = order[w0:w0 + WARP]
        for c in range(4):
            step = []
            groups = {}
            for p in lanes:
                key = int(tile[p]) * L.BINS + int(bins[p, c])
                if scheme == "apart" and bins[p, c] & 255 == 0:
                    continue
                if scheme == "match" or (scheme == "ballot"
                                         and bins[p, c] & 255 == 0):
                    groups[key] = groups.get(key, 0) + 1
                else:
                    step.append((key, 1))
            step.extend(groups.items())
            rnd.shuffle(step)
            for key, k in step:
                keys.append(key)
                ks.append(k)
    return np.array(keys, np.int64), np.array(ks, np.int64)


def _telescoped(keys, ks):
    """Each batch's delta k bias(b) - (nlogn(old + k) - nlogn(old)), in
    application order, with ``old`` the key's count before it (k = 1
    through d1, as the kernel reads it)."""
    order = np.argsort(keys, kind="stable")
    key, k = keys[order], ks[order]
    total = np.cumsum(k)
    start = np.r_[0, np.flatnonzero(key[1:] != key[:-1]) + 1]
    first = np.repeat(start, np.diff(np.r_[start, len(key)]))
    old = total - k - (total[first] - k[first])
    assert (old + k).max(initial=0) <= L.MAX_COUNT
    dn = np.where(k == 1, D1[np.minimum(old, L.MAX_COUNT - 1)],
                  NLOGN[old + k] - NLOGN[old])
    deltas = np.empty_like(keys)
    deltas[order] = k * BIAS[key & 255] - dn
    return deltas


def _plain_stage1(bins_m, tile, T):
    """4 nlogn(n) + sum_b (h_b bias(b) - nlogn(h_b)) of each tile."""
    hist = np.bincount((tile[:, None] * L.BINS + bins_m).reshape(-1),
                       minlength=T * L.BINS).reshape(T, L.BINS)
    npx = np.bincount(tile, minlength=T)
    return (4 * NLOGN[npx] + (hist * np.tile(BIAS, 4)).sum(1)
            - NLOGN[hist].sum(1))


def test_stage1_kernel_table_layout():
    """nlogn(0..1024), the 256 biases, then nlogn's first differences."""
    base = L.stage1_table()
    assert TAB.dtype == np.int64 and len(TAB) == 1025 + 256 + 1024
    assert np.array_equal(TAB[:len(base)], base)
    assert np.array_equal(D1, NLOGN[1:] - NLOGN[:-1])
    assert NLOGN[0] == 0 and BIAS[0] == 0


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**63 - 1))
@pytest.mark.parametrize("scheme", ["single", "ballot", "match", "apart"])
@pytest.mark.parametrize("bits,h,w,kind", [(2, 23, 30, "photo"),
                                           (3, 40, 33, "photo"),
                                           (4, 37, 48, "flat"),
                                           (4, 37, 48, "photo"),
                                           (5, 64, 45, "photo")])
def test_telescoped_stage1_equals_plain(bits, h, w, kind, scheme, seed):
    """Scores summed increment by increment, in an order and batching the
    kernel may use (hypothesis draws the order's seed), equal the plain
    stage-1 scores to the bit, pick the plain version's modes, and no
    partial sum reaches 2^58."""
    rnd = random.Random(seed)
    x = _words(h, w, seed=bits, kind=kind)
    bins, tile = _mode_bins(x, bits)
    T = int(tile.max()) + 1
    npx = np.bincount(tile, minlength=T)
    scores = np.empty((L.NUM_MODES, T), np.int64)
    for m in range(L.NUM_MODES):
        keys, ks = _batches(bins[m], tile, scheme, rnd)
        deltas = _telescoped(keys, ks)
        assert np.abs(np.cumsum(deltas)).max() < 1 << 58
        scores[m] = 4 * NLOGN[npx]
        np.add.at(scores[m], keys // L.BINS, deltas)       # int64, exact
        if scheme == "apart":         # byte 0 of each channel, its count
            for c in range(4):
                z = np.bincount(tile[bins[m][:, c] == c * 256], minlength=T)
                scores[m] += z * BIAS[0] - NLOGN[z]
        assert np.array_equal(scores[m], _plain_stage1(bins[m], tile, T)), m
    want = K.predictor_search_entropy_plain(x, bits, 0).numpy().reshape(-1)
    assert np.array_equal(scores.argmin(0), want)


@settings(max_examples=30, deadline=None)
@given(steps=st.lists(st.tuples(st.integers(0, 3), st.integers(1, 32)),
                      min_size=1, max_size=120),
       first=st.integers(0, L.MAX_COUNT))
@pytest.mark.parametrize("width,most", [(16, L.MAX_COUNT), (8, 64)])
def test_packed_counts(width, most, steps, first):
    """A mode's counts as the kernel packs them: 32 / width fields a word,
    row c % rows of 256 words holding channel c's bins in field c / rows
    (16 bits from bits 4 on, where a tile reaches 1,024 counts: channels 0
    and 2 share a word, 1 and 3; 8 bits up to bits 3, 64 counts: the four
    channels of one byte value).  An atomic add of k << shift returns the
    old word, whose field (old >> shift) & mask is the bin's count before
    the add; a channel of a tile has at most ``most`` counts, so no field
    carries into its neighbour."""
    per = 32 // width
    rows = 4 // per
    mask = (1 << width) - 1
    words = {}
    counts = {}
    for c, k in [(0, first)] + [(c, k) for c, k in steps]:
        k = min(k, most - counts.get(c, 0))
        if k == 0:
            continue
        row, sh = c % rows, (c // rows) * width
        old = words.get(row, 0)
        words[row] = (old + (k << sh)) & 0xFFFFFFFF
        assert (old >> sh) & mask == counts.get(c, 0)
        counts[c] = counts.get(c, 0) + k
    for row, word in words.items():
        assert word == sum(n << ((c // rows) * width)
                           for c, n in counts.items() if c % rows == row)
    full = sum(most << (f * width) for f in range(per))   # every field full
    assert full < 1 << 32
    assert all((full >> (f * width)) & mask == most for f in range(per))


def test_swar_byte_subtraction_matches_sub_pixels():
    """The kernel's byte-wise (x - p) mod 256, ((x | H) - (p & L)) ^ ((x ^
    ~p) & H) with H = 0x80808080, L = 0x7f7f7f7f, on random words and on
    the bytes 0, 1, 127, 128, 255 against each other, equals
    ops/lossless.py's ``_sub_pixels``."""
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 127, 128, 255], np.uint64)
    bytes4 = np.stack(np.meshgrid(edge, edge, edge, edge), -1).reshape(-1, 4)
    words = (bytes4 << np.array([24, 16, 8, 0], np.uint64)).sum(1)
    x = np.concatenate([np.repeat(words, len(words)), rng.integers(
        0, 1 << 32, 20000, dtype=np.uint64)])
    p = np.concatenate([np.tile(words, len(words)), rng.integers(
        0, 1 << 32, 20000, dtype=np.uint64)])
    H, Lo, M = 0x80808080, 0x7F7F7F7F, 0xFFFFFFFF
    swar = ((((x | H) - (p & Lo)) & M) ^ ((x ^ (~p & M)) & H))
    want = L._sub_pixels(torch.from_numpy(x.astype(np.int64)),
                         torch.from_numpy(p.astype(np.int64))).numpy()
    assert np.array_equal(swar.astype(np.int64), want)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**63 - 1), distinct=st.integers(1, 256))
def test_partial_sums_stay_under_2_58(seed, distinct):
    """A bits-5 tile at full count (1,024 pixels, 4,096 increments a mode):
    the deltas have both signs, so every partial sum in any order must fit,
    not only the total.  The nlogn differences are >= 0 and telescope per
    bin, so the negative part never exceeds 4 nlogn(1024); the positive
    part never exceeds 4,096 times the largest bias."""
    rnd = random.Random(seed)
    byte_vals = [rnd.randrange(256) for _ in range(distinct)]
    bins = np.array([[c * 256 + byte_vals[rnd.randrange(distinct)]
                      for c in range(4)] for _ in range(L.MAX_COUNT)])
    tile = np.zeros(L.MAX_COUNT, np.int64)
    keys, ks = _batches(bins, tile, rnd.choice(["single", "ballot", "match"]),
                        rnd)
    prefix = np.cumsum(_telescoped(keys, ks))
    neg, pos = 4 * int(NLOGN[L.MAX_COUNT]), 4 * L.MAX_COUNT * int(BIAS.max())
    assert -neg <= prefix.min() and prefix.max() <= pos
    assert max(neg, pos) < 1 << 58
    assert np.all(np.diff(NLOGN) >= 0)


def test_round_score_by_lookups_equals_histogram_dot():
    """A round's score: the per-pixel sum of q over each residual byte
    equals sum_b h_b q(b) for every mode and tile (the kernel keeps no
    histogram in a round), on a refine_table of this image's picks."""
    x = _words(53, 70, seed=9)
    bits = 3
    bins, tile = _mode_bins(x, bits)
    T = int(tile.max()) + 1
    modes = K.predictor_search_entropy_plain(x, bits, 0).numpy().reshape(-1)
    chosen = bins[modes[tile], np.arange(len(tile))]
    glob = np.bincount(chosen.reshape(-1), minlength=L.BINS)
    q = L.refine_table(glob, np.bincount(modes, minlength=14), T)
    for m in range(L.NUM_MODES):
        lookups = np.zeros(T, np.int64)
        np.add.at(lookups, tile, q[bins[m]].sum(1))
        hist = np.zeros((T, L.BINS), np.int64)
        np.add.at(hist, (np.repeat(tile, 4), bins[m].reshape(-1)), 1)
        assert np.array_equal(lookups, (hist * q[:L.BINS]).sum(1)), m


def _fold(v, seg):
    """The kernel's ``fold``: each step over offsets seg/2 .. 1 keeps half
    the values a lane holds (the upper half on lanes with the offset's bit
    set) and adds the partner's other half; once one value is left, a plain
    exchange.  v: (32, 16) int64 → (v0 of each lane, its value index)."""
    v = v.copy()
    idx = np.zeros(WARP, np.int64)
    n = 16
    lanes = np.arange(WARP)
    off = seg // 2
    while off:
        partner = lanes ^ off
        up = (lanes & off) != 0
        if n == 1:
            v[:, 0] = v[:, 0] + v[partner, 0]
        else:
            half = n // 2
            lo, hi = v[:, :half].copy(), v[:, half:n].copy()
            send = np.where(up[:, None], lo, hi)
            keep = np.where(up[:, None], hi, lo)
            v[:, :half] = keep + send[partner]
            idx += np.where(up, half, 0)
            n = half
        off //= 2
    return v[:, 0], idx


@pytest.mark.parametrize("seg", [16, 32])
def test_transposing_fold_sums_each_value_over_its_segment(seg):
    rng = np.random.default_rng(seg)
    v = rng.integers(-(1 << 52), 1 << 52, (WARP, 16))
    got, idx = _fold(v, seg)
    for lane in range(WARP):
        s0 = lane - lane % seg
        assert got[lane] == v[s0:s0 + seg, idx[lane]].sum()
    # the lanes that write part[] (every lane of a 16-lane segment, the
    # even lanes of a 32-lane one) hold each value index once a segment
    writers = np.arange(WARP) if seg == 16 else np.arange(0, WARP, 2)
    for s0 in range(0, WARP, seg):
        mine = idx[writers[(writers >= s0) & (writers < s0 + seg)]]
        assert sorted(mine) == list(range(16))
    want = (np.arange(WARP) >> 1) & 15 if seg == 32 else np.arange(WARP) & 15
    assert np.array_equal(idx, want)


@pytest.mark.parametrize("h,w", [(23, 31), (1, 17), (17, 1)])
def test_opaque_pixels_have_zero_alpha_residuals_in_every_mode(h, w):
    """The kernel leaves the alpha channel out of a block of tiles (stage
    1) or of a warp's pixels (a round) when every alpha that a pixel's
    predictions read, and its own, is 255 (``opaque``: the pixel, and L, T,
    TL, TR or the edge rule's one neighbour): then every mode's alpha
    residual is 0, the same bin in every mode.  Held on images with a few
    alphas below 255, pixel by pixel."""
    rng = np.random.default_rng(h * w)
    argb = rng.integers(0, 1 << 24, (h, w), dtype=np.uint64) | (255 << 24)
    holes = rng.random((h, w)) < 0.05
    argb[holes] = (argb[holes] & 0xFFFFFF) | (rng.integers(
        0, 255, holes.sum(), dtype=np.uint64) << 24)
    x = torch.from_numpy(argb.astype(np.uint32).view(np.int32))
    a = (argb >> 24) == 255
    pad = np.pad(a, 1, constant_values=True)
    near = (pad[1:-1, :-2] & pad[:-2, 1:-1] & pad[:-2, :-2]
            & pad[:-2, 2:])                   # L, T, TL, TR
    near[1:, -1] &= a[1:, 0]                  # TR of the last column
    near[0, 1:] = a[0, :-1]                   # row 0 reads L
    near[1:, 0] = a[:-1, 0]                   # column 0 reads T
    near[0, 0] = True                         # the origin reads black
    flag = a & near
    words = L.to_words(x)
    for m in range(L.NUM_MODES):
        alpha = (L._sub_pixels(words, L.predict_plane(words, m)).numpy()
                 >> 24) & 0xFF
        assert np.all(alpha[flag] == 0), m
    assert flag.sum() < h * w                 # some pixels not opaque
