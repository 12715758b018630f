"""The VP8L predictor inverse and add-green inverse against the JAX package.

``predictor_inverse`` (ops/kernels/vp8l_inverse.py's plain version on the
CPU) and ``add_green_inverse`` must equal gowebp_tpu/ops/lossless_jax.py's
bit for bit: every one of the 14 predictors (a whole mode image of one
mode, and mixed maps), tile bits 2-5, widths 1, 2 and odd, heights 1 and
odd, modes past 13.  The kernel's predictor as it writes it (byte-wise
words, the clamped predictors on 16-bit lanes of channel pairs), in
numpy, must equal ``apply_predictor`` for every mode on random words.  A
numpy model of ``vp8l_inverse.cu``'s schedule (a warp's lanes on
consecutive rows with their shuffle history, row groups chained through
marked edge words that become visible late and in any order, lane 0's
queue of them, the residual ring and output vectors, the candidate table
read at the lane's mode word, CTAs that take their rows from a ticket in
a random launch order) must give the plain
version's pixels, with every value a lane reads the pixel it stands for.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gowebp_tpu.ops.lossless_jax import add_green_inverse as jax_add_green
from gowebp_tpu.ops.lossless_jax import predictor_inverse as jax_inverse
from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
from gowebp_tpu_torch.ops.kernels.vp8l_inverse import predictor_inverse_plain
from gowebp_tpu_torch.ops.lossless import (add_green_inverse,
                                           predictor_inverse)


def _case(seed, h, w, bits, mode=None, top=14):
    rng = np.random.default_rng(seed)
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    res = rng.integers(0, 1 << 32, (2, h, w), dtype=np.uint32)
    modes = (rng.integers(0, top, (th, tw), dtype=np.uint32)
             if mode is None else np.full((th, tw), mode, np.uint32))
    # the other bytes of a mode word are ignored
    mode_img = (rng.integers(0, 1 << 32, (th, tw), dtype=np.uint32)
                & np.uint32(0xFFFF00FF)) | (modes << 8)
    return res, mode_img


def _port(res, mode_img, bits, add_green=False):
    out = predictor_inverse(torch.from_numpy(res.view(np.int32)),
                            torch.from_numpy(mode_img.view(np.int32)), bits,
                            add_green=add_green)
    return out.numpy().view(np.uint32)


def _jax(res, mode_img, bits, add_green=False):
    out = [jax_inverse(jnp.asarray(r), jnp.asarray(mode_img), bits)
           for r in res]
    if add_green:
        out = [jax_add_green(o) for o in out]
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("mode", range(14))
def test_each_predictor_matches_jax(mode):
    res, mode_img = _case(mode, 11, 13, 2, mode=mode)
    np.testing.assert_array_equal(_port(res, mode_img, 2),
                                  _jax(res, mode_img, 2))


@pytest.mark.parametrize("bits", [2, 3, 4, 5])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (7, 1), (5, 2), (9, 17),
                                 (33, 7)])
def test_mixed_modes_match_jax(h, w, bits):
    res, mode_img = _case(h * 100 + w + bits, h, w, bits)
    np.testing.assert_array_equal(_port(res, mode_img, bits),
                                  _jax(res, mode_img, bits))


@pytest.mark.parametrize("h,w", [(1, 5), (6, 3), (19, 21)])
def test_add_green_epilogue_matches_jax(h, w):
    res, mode_img = _case(h + w, h, w, 3)
    np.testing.assert_array_equal(_port(res, mode_img, 3, add_green=True),
                                  _jax(res, mode_img, 3, add_green=True))


def test_modes_past_13_predict_zero_as_jax():
    """The reference's select has no case past mode 13: it predicts 0."""
    res, mode_img = _case(5, 9, 10, 2, top=16)
    assert ((mode_img >> 8) & 255).max() >= 14
    np.testing.assert_array_equal(_port(res, mode_img, 2),
                                  _jax(res, mode_img, 2))


@pytest.mark.parametrize("shape", [(1,), (3, 7), (2, 5, 4)])
def test_add_green_inverse_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    argb = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    got = add_green_inverse(torch.from_numpy(argb.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jax_add_green(jnp.asarray(argb))))


def test_predictor_inverse_checks_its_mode_image():
    res = torch.zeros((1, 9, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode_img"):
        predictor_inverse(res, torch.zeros((2, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match=r"\(B, h, w\)"):
        predictor_inverse(res[0], torch.zeros((3, 3), dtype=torch.int32), 2)


# ---------------------------------------------------------------------------
# The kernel's predictor as it writes it, in numpy
# ---------------------------------------------------------------------------

SOURCE = (KERNEL_DIR / "vp8l_inverse.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


# (rows a warp, warps a CTA, row-above copies ahead), skew 2; the launcher
# picks 1 to kMaxWarps warps a CTA
KERNEL = (_const("kRows"), _const("kMaxWarps"), _const("kEdgeAhead"))
KERNEL_1 = (KERNEL[0], 1) + KERNEL[2:]
SKEW = _const("kSkew")
RES_AHEAD, RES_SLOTS = _const("kResAhead"), _const("kResSlots")
SMALL = (4, 2, 1)                # every boundary within a few rows
MARK = 1 << 32
BLACK = 0xFF000000


def _u32(v):
    return np.asarray(v, np.uint32)


def avg2(a, b):                                     # __vhaddu4
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def add_bytes(a, b):                                # __vadd4
    return ((a & 0x7F7F7F7F) + (b & 0x7F7F7F7F)) ^ ((a ^ b) & 0x80808080)


def byte_perm(x, y, s):
    """__byte_perm: byte k of the result is byte (s >> 4k) & 7 of y:x."""
    xy = (_u32(y).astype(np.uint64) << 32) | _u32(x).astype(np.uint64)
    out = np.zeros(np.shape(xy), np.uint64)
    for k in range(4):
        sel = (s >> 4 * k) & 7
        out |= ((xy >> np.uint64(8 * sel)) & np.uint64(255)) << np.uint64(8 * k)
    return _u32(out)


def even_ch(v, biased=False):
    return byte_perm(v, 0xFFFFFFFF if biased else 0, 0x4240)


def odd_ch(v, biased=False):
    return byte_perm(v, 0xFFFFFFFF if biased else 0, 0x4341)


def join_ch(e, o):
    return byte_perm(e, o, 0x6240)


def _s16(v, k):
    h = (_u32(v).astype(np.int64) >> 16 * k) & 0xFFFF
    return h - ((h >> 15) << 16)


def viaddmin_s16x2_relu(a, b, c):
    """max(min(a + b, c), 0) on each signed 16-bit lane."""
    out = 0
    for k in (0, 1):
        r = np.maximum(np.minimum(_s16(a, k) + _s16(b, k), _s16(c, k)), 0)
        assert (r < 1 << 15).all()
        out = out | (r << 16 * k)
    return _u32(out)


def vsadu4(a, b):
    a, b = _u32(a).astype(np.int64), _u32(b).astype(np.int64)
    return sum(np.abs(((a >> s) & 255) - ((b >> s) & 255))
               for s in (0, 8, 16, 24))


def clamp_full2(l_biased, t, tl):
    return viaddmin_s16x2_relu(l_biased, _u32(t + 0x01000100 - tl), 0x00FF00FF)


def clamp_half2(a, tl):
    k = _u32(0x01000100 - tl)
    neg = ~((a + k) >> 8) & 0x00010001
    h = ((a * 3 + k + neg) >> 1) & 0x01FF01FF
    return viaddmin_s16x2_relu(_u32(h), 0xFF80FF80, 0x00FF00FF)


def slot_word(s):
    return (s >> 2) * 128 + (s & 3)


def mode_word(word):
    """The table word of a mode word's mode m: slot m - 1, black's for 0,
    0's past 13."""
    m = (np.asarray(word, np.int64) >> 8) & 255
    return slot_word(np.where(m == 0, 13, np.where(m > 13, 14, m - 1)))


def candidates(l, t, tl, tr, c8=None):
    """vp8l_inverse.cu's candidates: each lane's table by slot, (n, 16),
    and avg2(T, TR), the next step's c8 (given, c8 stands for avg2(TL, T))."""
    a = avg2(l, t)
    c6, c9 = avg2(l, tl), avg2(t, tr)
    tle, tlo = even_ch(tl), odd_ch(tl)
    sel = np.where(vsadu4(t, tl) < vsadu4(l, tl), l, t)
    full = join_ch(clamp_full2(even_ch(l, True), even_ch(t), tle),
                   clamp_full2(odd_ch(l, True), odd_ch(t), tlo))
    half = join_ch(clamp_half2(even_ch(a), tle), clamp_half2(odd_ch(a), tlo))
    tab = np.zeros((np.size(l), 16), np.uint32)
    c8 = avg2(tl, t) if c8 is None else c8
    for s, c in enumerate((l, t, tr, tl, avg2(avg2(l, tr), t), c6, a,
                           c8, c9, avg2(c6, c9), sel, full, half, BLACK)):
        tab[:, s] = c
    return tab, c9


def read_word(tab, word):
    """The table word at offset ``word`` of each lane."""
    word = np.asarray(word, np.int64)
    assert ((word & 127) < 4).all()
    return tab[np.arange(len(tab)), (word >> 7) * 4 + (word & 3)]


def predict(m, l, t, tl, tr):
    """The kernel's prediction of mode m: its table word."""
    return read_word(candidates(l, t, tl, tr)[0],
                     mode_word(np.asarray(m) << 8))


def add_green_px(v):
    return (((v & 0x00FF00FF) + byte_perm(v, 0, 0x4141)) & 0x00FF00FF) | (
        v & 0xFF00FF00)


@pytest.mark.parametrize("mode", range(16))
def test_kernel_predictor_words_equal_apply_predictor(mode):
    """2^16 random word quadruples, each channel's edge values 0 and 255
    made common: the kernel's branch-free predictor == apply_predictor
    (0 past mode 13), and its add and add-green == the plain version's."""
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import (add_green_words,
                                                           add_pixels)
    from gowebp_tpu_torch.ops.lossless import apply_predictor

    rng = np.random.default_rng(2000 + mode)
    words = rng.integers(0, 1 << 32, (4, 1 << 16), dtype=np.uint32)
    edge = rng.integers(0, 4, (4, 1 << 16, 4))      # per channel: 0, 255
    for c in range(4):
        for v, k in ((0, 0), (255, 1)):
            sel = edge[:, :, c] == k
            words[sel] = (words[sel] & ~np.uint32(255 << 8 * c)) | np.uint32(
                v << 8 * c)
    l, t, tl, tr = words
    got = predict(np.full(l.shape, mode, np.uint32), l, t, tl, tr)
    if mode < 14:
        want = apply_predictor(mode, *(torch.from_numpy(v.astype(np.int64))
                                       for v in (l, t, tl, tr))).numpy()
    else:
        want = np.zeros_like(got)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    x = torch.from_numpy(l.astype(np.int64))
    p = torch.from_numpy(t.astype(np.int64))
    np.testing.assert_array_equal(add_bytes(l, t).astype(np.int64),
                                  add_pixels(x, p).numpy())
    np.testing.assert_array_equal(add_green_px(l).astype(np.int64),
                                  add_green_words(x).numpy())


# ---------------------------------------------------------------------------
# A numpy model of vp8l_inverse.cu's schedule
# ---------------------------------------------------------------------------

def test_model_reads_the_kernels_lines():
    assert SKEW == 2 and KERNEL[0] == 32
    for line in (
            "const int b = s_ticket % B;",
            "const int g = (s_ticket / B) * (int)(blockDim.x >> 5) + warp;",
            "r.iters = (w + kSkew * (nrows - 1) + 3) >> 2;",
            "int kb = -((lane + 1) >> 1);",
            "wait_edge(above + min(4 * kEdgeAhead, w - 1));",
            "tr = above_px((uint32_t)wait_edge(above));",
            "fetch_edge(r.edge + 2 * j, r.dummy, above, 4 * j + 1, w, lane0);",
            "fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + 2 + j, w, r.act);",
            "static_assert(kResAhead == kEdgeAhead + 2, \"the prologue's "
            "vectors meet the loop's\");",
            "const int x0 = 4 * i - kSkew * lane;",
            'asm volatile("cp.async.wait_group 3;" ::: "memory");',
            "const ulonglong2 p0 = r.edge[2 * (i & (kEdgeSlots - 1))];",
            "if (above && !((e[0] & e[1] & e[2] & e[3]) >> 32)) {",
            "if (c + j < w && !(e[j] >> 32)) e[j] = wait_edge(above + c + j);",
            "const uint2 r23 = *reinterpret_cast<const uint2*>(r.odd ? v1 : "
            "v0 + 2);",
            "uint32_t v = nv;",
            "if (lane == 0) v = (uint32_t)e[j];",
            "tr = above_px(v);",
            "uint32_t& m = j == 0 ? m0 : m2;",
            "m = __ldg(r.mrow + max(0, min((x + 4) >> bits, r.tw - 1)));",
            "c8 = candidates(r.tab, left, t, tl, x + 1 < w ? tr.v : first, "
            "c8);",
            "add_bytes(res4[j], reinterpret_cast<const uint32_t*>(r.tab)"
            "[x == 0 ? at0 : moff]);",
            "nv = __shfl_up_sync(kFull, made, 1);",
            "if (r.below && in) st_edge(r.below + x, kMark | px);",
            "if ((j == 1 && r.odd) || (j == 3 && !r.odd))",
            "const int n = i + kEdgeAhead;",
            "fetch_edge(r.edge + 2 * (n & (kEdgeSlots - 1)), r.dummy, above, "
            "4 * n + 1, w, lane0);",
            "fetch_vec<kVec>(r.ring, r.rrow, r.res, kb + kResAhead, w, r.act);",
            "return 2 + (long long)B * (groups - 1) * edge_stride(w);"):
        assert line in SOURCE, line


class Deadlock(AssertionError):
    """Every resident warp waits on a word no resident warp will store."""


class _EdgeRows:
    """The scratch's 64-bit words as other warps see them: a store becomes
    visible a random number of scheduler events later, so stores land in
    no particular order.  Each word is written once."""

    def __init__(self, n, rng, max_delay):
        self.words = [0] * n
        self.pending = []
        self.rng, self.max_delay, self.clock = rng, max_delay, 0

    def store(self, i, v):
        due = self.clock + int(self.rng.integers(0, self.max_delay + 1))
        self.pending.append((due, i, v))

    def tick(self):
        self.clock += 1
        keep = []
        for due, i, v in self.pending:
            if due <= self.clock:
                assert self.words[i] == 0, "an edge word written twice"
                self.words[i] = v
            else:
                keep.append((due, i, v))
        self.pending = keep


class _Model:
    def __init__(self, res, mode_img, bits, add_green, consts, seed, vec,
                 ticketed):
        self.B, self.h, self.w = res.shape
        self.R, self.W, self.ahead = consts
        self.res, self.bits, self.add_green = res, bits, add_green
        self.mwords = mode_img
        self.modes = (mode_img >> 8) & 255
        self.tw = mode_img.shape[1]
        self.vec = self.w % 4 == 0 if vec is None else vec
        assert not self.vec or self.w % 4 == 0
        self.rng = np.random.default_rng(seed)
        self.groups = -(-self.h // self.R)
        self.ticketed = ticketed
        plain = predictor_inverse_plain(
            torch.from_numpy(res.view(np.int32)),
            torch.from_numpy(mode_img.view(np.int32)), bits)
        self.truth = plain.numpy().view(np.uint32)      # before the epilogue
        self.stride = self.w + (self.w & 1)
        self.edges = _EdgeRows(2 + self.B * (self.groups - 1) * self.stride,
                               self.rng, int(self.rng.integers(0, 60)))
        self.out = np.zeros_like(res)
        self.written = np.zeros(res.shape, np.int64)

    def load_vec(self, b, y, act, k):
        out = np.zeros((self.R, 4), np.uint32)
        x = 4 * k
        for e in range(4):
            ok = act & (x >= 0) & (x + e < self.w)
            out[ok, e] = self.res[b, y[ok], x[ok] + e]
        return out

    def wait(self, i):
        while True:
            v = self.edges.words[i]
            if v >> 32:
                return v
            yield False

    def warp(self, b, g):
        """One warp of the kernel, lanes as numpy arrays; yields True after
        each iteration of 4 steps, False after a poll of an unmarked
        word."""
        R, w, h, bits = self.R, self.w, self.h, self.bits
        lanes = np.arange(R)
        y = g * R + lanes
        act = y < h
        yc = np.minimum(y, h - 1)
        nrows = min(R, h - g * R)
        edge0 = 1 + b * (self.groups - 1) * self.stride
        above = edge0 + (g - 1) * self.stride if g > 0 else None
        below = edge0 + g * self.stride if g + 1 < self.groups else None
        odd = (lanes & 1).astype(bool)
        top = y == 0
        tmask = (1 << bits) - 1
        truth, res = self.truth[b], self.res[b]
        kb = -((lanes + 1) >> 1)
        ring = {}                             # vector k of each lane's row

        def fetch_vec(k):
            vecs = self.load_vec(b, y, act, k)
            for j in range(R):
                ring[j, int(k[j])] = vecs[j]

        for k in range(RES_AHEAD):
            fetch_vec(kb + k)
        mrow = self.mwords[yc >> bits]
        m0 = m2 = mrow[:, 0]                  # the word of the tile of x + 4
        moff = np.full(R, slot_word(0))       # row 0: L's, always
        at0 = np.where(top, slot_word(13), slot_word(1))
        tiles = act & ~top
        # the edge ring: slot i holds words 4 i + 1 .. 4 i + 4 of the row
        # above, copied (cp.async, a weak read) either as the copy is
        # issued or as its group is awaited: both are what the card may read
        edge = {}
        copies = []                           # (iteration, words at issue)

        def fetch_edge(n):
            copies.append((n, [self.edges.words[above + c] if c < w else 0
                               for c in range(4 * n + 1, 4 * n + 5)]))

        def land(upto):
            # the copies of iterations <= upto are complete
            for n, early in [c for c in copies if c[0] <= upto]:
                late = [self.edges.words[above + c] if c < w else 0
                        for c in range(4 * n + 1, 4 * n + 5)]
                edge[n] = early if self.rng.integers(2) else late
            copies[:] = [c for c in copies if c[0] > upto]

        z = np.zeros(R, np.uint32)
        tr, t, tl, left, first, made, c8 = z, z, z, z, z, z, z
        if above is not None:
            yield from self.wait(above + min(4 * self.ahead, w - 1))
            v = yield from self.wait(above)
            tr = tr.copy()
            tr[0] = v & 0xFFFFFFFF
            for j in range(self.ahead):
                fetch_edge(j)
        o = np.zeros((R, 4), np.uint32)
        e = [0] * 4
        for i in range((w + SKEW * (nrows - 1) + 3) >> 2):
            x0 = 4 * i - SKEW * lanes
            if above is not None:
                land(i)                       # awaited at the head
                e = list(edge.pop(i))
                c = 4 * i + 1
                if not (e[0] & e[1] & e[2] & e[3]) >> 32:
                    for j in range(4):
                        if c + j < w and not e[j] >> 32:
                            e[j] = yield from self.wait(above + c + j)
            v0 = np.stack([ring[j, int(kb[j])] for j in range(R)])
            v1 = np.stack([ring[j, int(kb[j]) + 1] for j in range(R)])
            r = [np.where(odd, v0[:, 2], v0[:, 0]),
                 np.where(odd, v0[:, 3], v0[:, 1]),
                 np.where(odd, v1[:, 0], v0[:, 2]),
                 np.where(odd, v1[:, 1], v0[:, 3])]
            # the ring holds RES_SLOTS vectors a lane
            assert all(k[1] > int(kb[k[0]]) - RES_SLOTS for k in ring)
            for j in range(4):
                x = x0 + j
                xc = np.clip(x, 0, w - 1)
                v = np.empty(R, np.uint32)
                v[1:] = made[:-1]                       # __shfl_up_sync
                v[0] = e[j] & 0xFFFFFFFF
                if above is not None and x[0] + 1 < w:
                    assert e[j] >> 32, "lane 0 used an unmarked word"
                tl, t, tr = t, tr, v
                inn = act & (x >= 0) & (x < w)
                start = tiles & (x >= 0) & (x < w) & ((x & tmask) == 0)
                if bits < 2:
                    moff = np.where(start, mode_word(mrow[lanes, xc >> bits]),
                                    moff)
                elif j in (0, 2):
                    assert not (start & (odd != (j == 2))).any()
                    m = m0 if j == 0 else m2
                    moff = np.where(start, mode_word(m), moff)
                    m = mrow[lanes, np.clip((x + 4) >> bits, 0, self.tw - 1)]
                    m0, m2 = (m, m2) if j == 0 else (m0, m)
                else:
                    assert not start.any()
                # every value read is the pixel it stands for
                yu = np.maximum(yc - 1, 0)
                rows = inn & ~top
                inner = rows & (x > 0)
                tr_used = np.where(x + 1 < w, tr, first)
                tr_want = np.where(x + 1 < w,
                                   truth[yu, np.minimum(xc + 1, w - 1)],
                                   truth[yc, 0])
                assert (r[j][inn] == res[yc, xc][inn]).all()
                assert (t[rows] == truth[yu, xc][rows]).all()
                assert (tl[inner] == truth[yu, xc - 1][inner]).all()
                assert (tr_used[inner] == tr_want[inner]).all()
                assert (left[inn & (x > 0)]
                        == truth[yc, xc - 1][inn & (x > 0)]).all()
                want_off = mode_word(mrow[lanes, xc >> bits])
                assert (moff[inner] == want_off[inner]).all()
                tab, c8 = candidates(left, t, tl, tr_used, c8)
                at = np.where(x == 0, at0, moff)
                px = _u32(add_bytes(r[j], read_word(tab, at)))
                first = np.where(x == 0, px, first)
                left = made = px
                if below is not None and inn[R - 1]:
                    self.edges.store(below + x[R - 1], MARK | int(px[R - 1]))
                ov = _u32(add_green_px(px)) if self.add_green else px
                if self.vec:
                    o[:, j] = np.where(odd, o[:, j], ov)
                    o[:, j ^ 2] = np.where(odd, ov, o[:, j ^ 2])
                    if j in (1, 3):
                        st = (act & (odd if j == 1 else ~odd) & (kb >= 0)
                              & (4 * kb < w))
                        for ln in np.flatnonzero(st):
                            cols = slice(4 * kb[ln], 4 * kb[ln] + 4)
                            self.out[b, y[ln], cols] = o[ln]
                            self.written[b, y[ln], cols] += 1
                else:
                    self.out[b, y[inn], x[inn]] = ov[inn]
                    self.written[b, y[inn], x[inn]] += 1
            if above is not None:
                fetch_edge(i + self.ahead)
            fetch_vec(kb + RES_AHEAD)
            for j in range(R):
                ring.pop((j, int(kb[j])), None)
            kb = kb + 1
            yield True

    def run(self):
        """CTAs become resident in a random order, at most ``cap`` at a
        time; each takes the next ticket (or, untickets, its blockIdx) as
        its (image, CTA row); each event runs one random resident warp."""
        per_image = -(-self.groups // self.W)
        order = self.rng.permutation(self.B * per_image)
        cap = int(self.rng.integers(1, 4))
        resident, launched = [], 0
        while launched < len(order) or resident:
            while len(resident) < cap and launched < len(order):
                tk = launched if self.ticketed else int(order[launched])
                launched += 1
                b, row = tk % self.B, tk // self.B
                resident.append([[self.warp(b, g), True] for g in range(
                    row * self.W, min((row + 1) * self.W, self.groups))])
            warps = [wp for cta in resident for wp in cta]
            wp = warps[int(self.rng.integers(len(warps)))]
            try:
                wp[1] = next(wp[0])
            except StopIteration:
                for cta in resident:
                    if wp in cta:
                        cta.remove(wp)
                resident = [cta for cta in resident if cta]
            self.edges.tick()
            if (resident and not self.edges.pending
                    and not any(p for cta in resident for _, p in cta)):
                # memory no longer changes: one more poll each decides
                stuck = True
                for cta in resident:
                    for wp in cta:
                        wp[1] = next(wp[0])
                        stuck = stuck and not wp[1]
                if stuck:
                    raise Deadlock("every resident warp waits")
        assert (self.written == 1).all(), "a pixel stored other than once"
        return self.out


def _model(h, w, bits, add_green, consts, seed, vec=None, ticketed=True,
           B=2):
    res, mode_img = _case(seed, h, w, bits)
    res = np.concatenate([res] * (B // 2) + [res[:B % 2]])
    got = _Model(res, mode_img, bits, add_green, consts, seed, vec,
                 ticketed).run()
    want = predictor_inverse_plain(
        torch.from_numpy(res.view(np.int32)),
        torch.from_numpy(mode_img.view(np.int32)), bits, add_green)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


@pytest.mark.parametrize("h,w,bits,add_green,consts,vec", [
    (1, 70, 2, False, KERNEL, None),
    (31, 5, 3, True, KERNEL, None),
    (32, 3, 4, False, KERNEL, None),
    (33, 2, 5, True, KERNEL, None),
    (33, 1, 2, False, KERNEL, None),
    (4 * KERNEL[0] + 3, 5, 3, False, KERNEL, None),   # beyond one CTA
    (70, 68, 4, True, KERNEL, None),                  # 16-byte vectors
    (70, 68, 4, False, KERNEL, False),                # scalar, w % 4 == 0
    (4 * KERNEL[0] + 3, 9, 2, True, KERNEL_1, None),  # a warp a CTA
    (33, 1, 2, True, SMALL, None),
    (19, 70, 2, False, SMALL, None),
    (32, 5, 3, True, SMALL, None),
    (31, 3, 5, False, SMALL, None),
    (45, 68, 4, True, SMALL, None),
    (45, 68, 5, False, SMALL, False),
    (17, 12, 0, True, SMALL, None),                   # a tile a column
    (17, 13, 1, False, SMALL, None),
])
def test_kernel_schedule_model_equals_the_plain_version(h, w, bits, add_green,
                                                        consts, vec):
    for seed in range(2):
        _model(h, w, bits, add_green, consts, h * w + bits + 7 * seed, vec)


def test_model_without_the_ticket_deadlocks():
    """The check has teeth: with (image, CTA row) from blockIdx, a launch
    order that makes a lower CTA resident alone waits forever."""
    res, mode_img = _case(1, 20, 9, 2)
    for seed in range(50):
        m = _Model(res, mode_img, 2, False, SMALL, seed, None, False)
        try:
            m.run()
        except Deadlock:
            return
    pytest.fail("no launch order deadlocked without the ticket")
