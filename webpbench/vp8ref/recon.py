"""Plain reconstruction of a parsed VP8 key frame (RFC 6386 sections 12,
14, 15 and 20, with libwebp's edge rules): dequantization, the inverse
transforms, intra prediction, the loop filter, then libwebp's fancy
upsampling to RGBA.

Macroblocks are processed in anti-diagonal waves (x + 2y constant), in
which no macroblock depends on another, so each wave is a few NumPy
operations over all of its macroblocks.  The same waves can also re-derive
what a closed-loop encoder had to code (``LevelCheck``).
"""

from __future__ import annotations

import numpy as np

from .bitstream import (B_DC, B_HD, B_HE, B_HU, B_LD, B_RD, B_TM, B_VE,
                        B_VL, B_VR, H_PRED, TM_PRED, V_PRED, Frame)

I64 = np.int64


# ---- transforms ----------------------------------------------------------

def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct(c):
    """(..., 16) raster coefficients -> (..., 4, 4) residual."""
    c = c.reshape(c.shape[:-1] + (4, 4))
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i2, i0 - i2
    cc, d = _mul2(i1) - _mul1(i3), _mul1(i1) + _mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -1)   # [..., column, row]
    t0, t1, t2, t3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    dc = t0 + 4
    a, b = dc + t2, dc - t2
    cc, d = _mul2(t1) - _mul1(t3), _mul1(t1) + _mul2(t3)
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3   # [row, col]


def iwht(c):
    """(..., 16) raster Y2 coefficients -> (..., 16) DCs of blocks 0..15."""
    c = c.reshape(c.shape[:-1] + (4, 4))
    a0, a1 = c[..., 0, :] + c[..., 3, :], c[..., 1, :] + c[..., 2, :]
    a2, a3 = c[..., 1, :] - c[..., 2, :], c[..., 0, :] - c[..., 3, :]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -2)    # [row, col]
    dc = t[..., :, 0] + 3
    a0, a1 = dc + t[..., :, 3], t[..., :, 1] + t[..., :, 2]
    a2, a3 = t[..., :, 1] - t[..., :, 2], dc - t[..., :, 3]
    out = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], -1) >> 3
    return out.reshape(out.shape[:-2] + (16,))


def fdct(d):
    """(..., 4, 4) residual -> (..., 16) raster coefficients (the encoder's
    forward transform, libwebp's FTransform)."""
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
    t = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9,
                  (a0 - a1) * 8, (a3 * 2217 - a2 * 5352 + 937) >> 9], -1)
    t0, t1, t2, t3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a0, a1, a2, a3 = t0 + t3, t1 + t2, t1 - t2, t0 - t3
    out = np.stack([(a0 + a1 + 7) >> 4,
                    ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0),
                    (a0 - a1 + 7) >> 4,
                    (a3 * 2217 - a2 * 5352 + 51000) >> 16], -2)
    return out.reshape(out.shape[:-2] + (16,))


def fwht(dcs):
    """(..., 16) raster DCs of the 16 luma blocks -> (..., 16) Y2."""
    x = dcs.reshape(dcs.shape[:-1] + (4, 4))
    a0, a1 = x[..., :, 0] + x[..., :, 2], x[..., :, 1] + x[..., :, 3]
    a2, a3 = x[..., :, 1] - x[..., :, 3], x[..., :, 0] - x[..., :, 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], -1)    # [row, k]
    a0, a1 = t[..., 0, :] + t[..., 2, :], t[..., 1, :] + t[..., 3, :]
    a2, a3 = t[..., 1, :] - t[..., 3, :], t[..., 0, :] - t[..., 2, :]
    out = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], -2) >> 1
    return out.reshape(out.shape[:-2] + (16,))


# ---- 4x4 prediction as taps over the 13 edge pixels ----------------------
# edge vector: 0 = X (above-left), 1..8 = A..H (above, above-right),
# 9..12 = I..L (left); a pixel is (sum of weight x edge + 2) >> 2

def _tap_table():
    X, A, B, C, D, E, F, G, H, I, J, K, L = range(13)

    def avg3(a, b, c):
        w = np.zeros(13, I64)
        w[a] += 1
        w[b] += 2
        w[c] += 1
        return w

    def avg2(a, b):
        w = np.zeros(13, I64)
        w[a] += 2
        w[b] += 2
        return w

    def copy(a):
        w = np.zeros(13, I64)
        w[a] = 4
        return w

    W = np.zeros((10, 16, 13), I64)

    def put(mode, x, y, w):
        W[mode, 4 * y + x] = w

    top = (X, A, B, C, D, E)
    for x in range(4):
        for y in range(4):
            put(B_VE, x, y, avg3(top[x], top[x + 1], top[x + 2]))
    left = (X, I, J, K, L, L)
    for y in range(4):
        for x in range(4):
            put(B_HE, x, y, avg3(left[y], left[y + 1], left[y + 2]))
    # down-right: diagonal index x - y over the edge L K J I X A B C D
    edge = (L, K, J, I, X, A, B, C, D)
    for x in range(4):
        for y in range(4):
            k = x - y + 4
            put(B_RD, x, y, avg3(edge[k - 1], edge[k], edge[k + 1]))
    top8 = (A, B, C, D, E, F, G, H, H)
    for x in range(4):
        for y in range(4):
            k = x + y
            put(B_LD, x, y, avg3(top8[k], top8[k + 1], top8[k + 2]))
    # vertical-right
    for y, x, w in ((0, 0, avg2(X, A)), (2, 1, avg2(X, A)),
                    (0, 1, avg2(A, B)), (2, 2, avg2(A, B)),
                    (0, 2, avg2(B, C)), (2, 3, avg2(B, C)),
                    (0, 3, avg2(C, D)),
                    (3, 0, avg3(K, J, I)), (2, 0, avg3(J, I, X)),
                    (1, 0, avg3(I, X, A)), (3, 1, avg3(I, X, A)),
                    (1, 1, avg3(X, A, B)), (3, 2, avg3(X, A, B)),
                    (1, 2, avg3(A, B, C)), (3, 3, avg3(A, B, C)),
                    (1, 3, avg3(B, C, D))):
        put(B_VR, x, y, w)
    # vertical-left
    for y, x, w in ((0, 0, avg2(A, B)),
                    (0, 1, avg2(B, C)), (2, 0, avg2(B, C)),
                    (0, 2, avg2(C, D)), (2, 1, avg2(C, D)),
                    (0, 3, avg2(D, E)), (2, 2, avg2(D, E)),
                    (1, 0, avg3(A, B, C)),
                    (1, 1, avg3(B, C, D)), (3, 0, avg3(B, C, D)),
                    (1, 2, avg3(C, D, E)), (3, 1, avg3(C, D, E)),
                    (1, 3, avg3(D, E, F)), (3, 2, avg3(D, E, F)),
                    (2, 3, avg3(E, F, G)), (3, 3, avg3(F, G, H))):
        put(B_VL, x, y, w)
    # horizontal-down
    for y, x, w in ((0, 0, avg2(I, X)), (1, 2, avg2(I, X)),
                    (1, 0, avg2(J, I)), (2, 2, avg2(J, I)),
                    (2, 0, avg2(K, J)), (3, 2, avg2(K, J)),
                    (3, 0, avg2(L, K)),
                    (0, 3, avg3(A, B, C)), (0, 2, avg3(X, A, B)),
                    (0, 1, avg3(I, X, A)), (1, 3, avg3(I, X, A)),
                    (1, 1, avg3(J, I, X)), (2, 3, avg3(J, I, X)),
                    (2, 1, avg3(K, J, I)), (3, 3, avg3(K, J, I)),
                    (3, 1, avg3(L, K, J))):
        put(B_HD, x, y, w)
    # horizontal-up
    for y, x, w in ((0, 0, avg2(I, J)),
                    (0, 2, avg2(J, K)), (1, 0, avg2(J, K)),
                    (1, 2, avg2(K, L)), (2, 0, avg2(K, L)),
                    (0, 1, avg3(I, J, K)),
                    (0, 3, avg3(J, K, L)), (1, 1, avg3(J, K, L)),
                    (1, 3, avg3(K, L, L)), (2, 1, avg3(K, L, L)),
                    (2, 2, copy(L)), (2, 3, copy(L)), (3, 0, copy(L)),
                    (3, 1, copy(L)), (3, 2, copy(L)), (3, 3, copy(L))):
        put(B_HU, x, y, w)
    return W


TAPS = _tap_table()


def pred4(modes, e):
    """(M,) 4x4 modes, (M, 13) edges -> (M, 16) predictions."""
    p = (np.einsum("mpk,mk->mp", TAPS[modes], e) + 2) >> 2
    top, left, x = e[:, 1:5], e[:, 9:13], e[:, :1]
    dc = (top.sum(1) + left.sum(1) + 4) >> 3
    tm = np.clip(left[:, :, None] + top[:, None, :] - x[:, :, None], 0, 255)
    p = np.where((modes == B_DC)[:, None], dc[:, None], p)
    return np.where((modes == B_TM)[:, None], tm.reshape(-1, 16), p)


def pred_block(modes, top, left, tl, has_top, has_left, n):
    """Whole-block n x n prediction (16x16 luma or 8x8 chroma): (M,) modes,
    (M, n) top and left rows, (M,) corner -> (M, n, n)."""
    sh = n.bit_length() - 1
    st, sl = top.sum(1), left.sum(1)
    dc = np.where(has_top & has_left, (st + sl + n) >> (sh + 1),
                  np.where(has_top, (st + n // 2) >> sh,
                           np.where(has_left, (sl + n // 2) >> sh, 128)))
    M = len(modes)
    out = np.empty((M, n, n), I64)
    out[:] = dc[:, None, None]
    m = modes[:, None, None]
    out = np.where(m == V_PRED, top[:, None, :], out)
    out = np.where(m == H_PRED, left[:, :, None], out)
    tm = np.clip(left[:, :, None] + top[:, None, :] - tl[:, None, None],
                 0, 255)
    return np.where(m == TM_PRED, tm, out)


# ---- the encoder's quantizer, for LevelCheck -----------------------------
# rounding biases of the port's quantizer (in 1/256 of a step, << 9 below)
BIAS = {"y1_dc": 96, "y1_ac": 110, "y2_dc": 96, "y2_ac": 96,
        "uv_dc": 110, "uv_ac": 110}


def quantize(c, q_dc, q_ac, b_dc, b_ac):
    """(M, ..., 16) coefficients with (M,) steps -> levels."""
    extra = (1,) * (c.ndim - 1)
    pos0 = np.arange(16) == 0
    q = np.where(pos0, q_dc.reshape((-1,) + extra), q_ac.reshape((-1,) + extra))
    bias = np.where(pos0, b_dc << 9, b_ac << 9)
    lv = np.minimum((np.abs(c) * ((1 << 17) // q) + bias) >> 17, 2047)
    return np.where(c < 0, -lv, lv)


class LevelCheck:
    """Re-derives, from the source planes and the frame's own modes and
    segments, the levels a closed-loop encoder with the port's quantizer
    codes (libwebp's transforms, quantization with rounding bias, UV DC
    error diffusion), each block predicted from the decoded picture, and
    counts the blocks whose coded levels differ."""

    def __init__(self, y, u, v, diffusion: bool):
        self.src = (np.asarray(y, I64), np.asarray(u, I64),
                    np.asarray(v, I64))
        self.diffusion = diffusion
        self.bad = 0
        self.blocks = 0

    def start(self, fr: Frame):
        self.dt = np.zeros((fr.mb_w, 2, 2), I64)    # carries of the row above
        self.dl = np.zeros((fr.mb_h, 2, 2), I64)    # of the left neighbour

    def compare(self, want, got):
        want = want.reshape(-1, 16)
        got = got.reshape(-1, 16)
        self.bad += int((want != got).any(1).sum())
        self.blocks += len(want)

    def i16(self, fr, mx, my, pred, steps):
        ys = self.src[0]
        src = np.stack([ys[16 * b:16 * b + 16, 16 * a:16 * a + 16]
                        for a, b in zip(mx, my)])
        blk = (src - pred).reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
        cf = fdct(blk).reshape(-1, 16, 16)
        y2 = quantize(fwht(cf[..., 0]), steps[:, 2], steps[:, 3],
                      BIAS["y2_dc"], BIAS["y2_ac"])
        ac = quantize(cf, steps[:, 0], steps[:, 1], 0, BIAS["y1_ac"])
        ac[..., 0] = 0
        lv = fr.levels[my, mx]
        self.compare(y2, lv[:, 24])
        self.compare(ac, lv[:, :16])

    def i4(self, fr, mx, my, n, pred, steps):
        r, c = 4 * (n >> 2), 4 * (n & 3)
        ys = self.src[0]
        src = np.stack([ys[16 * b + r:16 * b + r + 4, 16 * a + c:16 * a + c + 4]
                        for a, b in zip(mx, my)])
        cf = fdct(src - pred.reshape(-1, 4, 4))
        lv = quantize(cf, steps[:, 0], steps[:, 1], BIAS["y1_dc"],
                      BIAS["y1_ac"])
        self.compare(lv, fr.levels[my, mx, n])

    def uv(self, fr, mx, my, preds, steps):
        cfs = []
        for ch in range(2):
            plane = self.src[1 + ch]
            src = np.stack([plane[8 * b:8 * b + 8, 8 * a:8 * a + 8]
                            for a, b in zip(mx, my)])
            blk = (src - preds[ch]).reshape(-1, 2, 4, 2, 4).transpose(
                0, 1, 3, 2, 4)
            cfs.append(fdct(blk).reshape(-1, 4, 16))
        cf = np.stack(cfs, 1)                       # (M, 2, 4, 16)
        if self.diffusion:
            qd = steps[:, 4]
            iq = (1 << 17) // qd
            bias = BIAS["uv_dc"] << 9

            def err(vv):
                av = np.abs(vv)
                lvl = np.minimum((av * iq + bias) >> 17, 2047)
                e = av - lvl * qd
                return np.where(vv < 0, -e, e) >> 1

            dt = np.where((my > 0)[:, None, None], self.dt[mx], 0)
            dl = np.where((mx > 0)[:, None, None], self.dl[my], 0)
            nl = np.zeros_like(dt)
            nt = np.zeros_like(dt)
            for ch in range(2):
                dc = cf[:, ch, :, 0]
                c0 = dc[:, 0] + ((7 * dt[:, ch, 0] + 8 * dl[:, ch, 0]) >> 3)
                e0 = err(c0)
                c1 = dc[:, 1] + ((7 * dt[:, ch, 1] + 8 * e0) >> 3)
                e1 = err(c1)
                c2 = dc[:, 2] + ((7 * e0 + 8 * dl[:, ch, 1]) >> 3)
                e2 = err(c2)
                c3 = dc[:, 3] + ((7 * e1 + 8 * e2) >> 3)
                e3 = err(c3)
                cf[:, ch, :, 0] = np.stack([c0, c1, c2, c3], 1)
                l1 = (3 * e3) >> 2
                nl[:, ch] = np.stack([e1, l1], 1)
                nt[:, ch] = np.stack([e2, e3 - l1], 1)
            wrap = lambda a: ((a + 32768) & 0xFFFF) - 32768   # noqa: E731
            self.dl[my] = wrap(nl)
            self.dt[mx] = wrap(nt)
        lv = quantize(cf.reshape(len(mx), 8, 16), steps[:, 4], steps[:, 5],
                      BIAS["uv_dc"], BIAS["uv_ac"])
        self.compare(lv, fr.levels[my, mx, 16:24])


# ---- reconstruction -------------------------------------------------------

def _waves(mb_w, mb_h):
    for t in range(mb_w + 2 * (mb_h - 1)):
        my = np.arange(mb_h)
        mx = t - 2 * my
        ok = (mx >= 0) & (mx < mb_w)
        if ok.any():
            yield mx[ok], my[ok]


def dequantize(fr: Frame):
    """(mb_h, mb_w, 24, 16) raster coefficients, the i16 DCs filled in."""
    st = fr.steps[fr.segment]                           # (mh, mw, 6)
    lv = fr.levels
    c = np.empty((fr.mb_h, fr.mb_w, 24, 16), I64)
    c[:, :, :16, :1] = lv[:, :, :16, :1] * st[:, :, None, 0:1]
    c[:, :, :16, 1:] = lv[:, :, :16, 1:] * st[:, :, None, 1:2]
    c[:, :, 16:, :1] = lv[:, :, 16:24, :1] * st[:, :, None, 4:5]
    c[:, :, 16:, 1:] = lv[:, :, 16:24, 1:] * st[:, :, None, 5:6]
    y2 = np.concatenate([lv[:, :, 24, :1] * st[:, :, 2:3],
                         lv[:, :, 24, 1:] * st[:, :, 3:4]], -1)
    i16 = fr.is_i4 == 0
    c[..., :16, 0] = np.where(i16[..., None], iwht(y2), c[..., :16, 0])
    return c


def reconstruct(fr: Frame, check: LevelCheck | None = None):
    """Unfiltered Y, U, V planes (MB-aligned) of the frame; with ``check``
    the coded levels are held against the encoder's as it goes."""
    mw, mh = fr.mb_w, fr.mb_h
    coef = dequantize(fr)
    res = idct(coef)                                    # (mh, mw, 24, 4, 4)
    # padded planes: row 0 and column 0 are the borders (127 above, 129
    # left, 127 in the corner); 4 spare columns for the above-right reads
    Y = np.zeros((16 * mh + 1, 16 * mw + 5), I64)
    Y[0, :] = 127
    Y[1:, 0] = 129
    C = np.zeros((2, 8 * mh + 1, 8 * mw + 1), I64)
    C[:, 0, :] = 127
    C[:, 1:, 0] = 129
    if check is not None:
        check.start(fr)
    lane_steps = fr.steps[fr.segment]
    for mx, my in _waves(mw, mh):
        ht, hl = my > 0, mx > 0
        steps = lane_steps[my, mx]
        y0, x0 = 16 * my, 16 * mx       # padded coords of the row/col before
        i4 = fr.is_i4[my, mx] == 1
        # ---- 16x16 luma
        s = ~i4
        if s.any():
            a, b = mx[s], my[s]
            ya, xa = y0[s], x0[s]
            top = Y[ya[:, None], xa[:, None] + 1 + np.arange(16)]
            left = Y[ya[:, None] + 1 + np.arange(16), xa[:, None]]
            tl = Y[ya, xa]
            pred = pred_block(fr.ymode[b, a], top, left, tl, ht[s], hl[s], 16)
            if check is not None:
                check.i16(fr, a, b, pred, steps[s])
            r = res[b, a, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4)
            rec = np.clip(pred + r.reshape(-1, 16, 16), 0, 255)
            for k in range(len(a)):
                Y[ya[k] + 1:ya[k] + 17, xa[k] + 1:xa[k] + 17] = rec[k]
        # ---- 4x4 luma, the 16 blocks in raster order
        if i4.any():
            a, b = mx[i4], my[i4]
            ya, xa = y0[i4], x0[i4]
            # above-right of the macroblock, reused by its right column
            tr = Y[ya[:, None], xa[:, None] + 17 + np.arange(4)]
            last = (a == mw - 1) & (b > 0)
            tr = np.where(last[:, None], Y[ya, xa + 16][:, None], tr)
            tr = np.where((b == 0)[:, None], 127, tr)
            for n in range(16):
                r, c = 4 * (n >> 2), 4 * (n & 3)
                ry, cx = ya + r, xa + c         # padded row/col before block
                e = np.empty((len(a), 13), I64)
                e[:, 0] = Y[ry, cx]
                e[:, 1:5] = Y[ry[:, None], cx[:, None] + 1 + np.arange(4)]
                if c == 12:
                    e[:, 5:9] = tr
                else:
                    e[:, 5:9] = Y[ry[:, None], cx[:, None] + 5 + np.arange(4)]
                e[:, 9:13] = Y[ry[:, None] + 1 + np.arange(4), cx[:, None]]
                pred = pred4(fr.imodes[b, a, n], e)
                if check is not None:
                    check.i4(fr, a, b, n, pred, steps[i4])
                rec = np.clip(pred.reshape(-1, 4, 4) + res[b, a, n], 0, 255)
                for k in range(len(a)):
                    Y[ry[k] + 1:ry[k] + 5, cx[k] + 1:cx[k] + 5] = rec[k]
        # ---- chroma
        cy, cx = 8 * my, 8 * mx
        preds = []
        for ch in range(2):
            P = C[ch]
            top = P[cy[:, None], cx[:, None] + 1 + np.arange(8)]
            left = P[cy[:, None] + 1 + np.arange(8), cx[:, None]]
            preds.append(pred_block(fr.uvmode[my, mx], top, left, P[cy, cx],
                                    ht, hl, 8))
        if check is not None:
            check.uv(fr, mx, my, preds, steps)
        for ch in range(2):
            r = res[my, mx, 16 + 4 * ch:20 + 4 * ch].reshape(-1, 2, 2, 4, 4)
            r = r.transpose(0, 1, 3, 2, 4).reshape(-1, 8, 8)
            rec = np.clip(preds[ch] + r, 0, 255)
            for k in range(len(mx)):
                C[ch, cy[k] + 1:cy[k] + 9, cx[k] + 1:cx[k] + 9] = rec[k]
    nz = (coef != 0).any(axis=(2, 3))
    return Y[1:, 1:16 * mw + 1], C[0, 1:, 1:], C[1, 1:, 1:], nz


# ---- loop filter ------------------------------------------------------------

def filter_params(fr: Frame, nonzero):
    """(mb_h, mb_w) limit, interior limit, hev threshold and inner flag
    (libwebp's PrecomputeFilterStrengths); limit 0 means no filtering."""
    shape = (fr.mb_h, fr.mb_w)
    limit = np.zeros(shape, I64)
    ilev = np.zeros(shape, I64)
    hev = np.zeros(shape, I64)
    inner = (fr.is_i4 == 1) | nonzero
    if fr.level == 0:
        return limit, ilev, hev, inner
    for s in range(4):
        base = fr.level
        if fr.use_segment:
            base = fr.seg_filter[s] + (0 if fr.absolute_delta else fr.level)
        for i4 in (0, 1):
            lvl = base
            if fr.use_lf_delta:
                lvl += fr.ref_lf_delta[0]
                if i4:
                    lvl += fr.mode_lf_delta[0]
            lvl = min(max(lvl, 0), 63)
            if lvl == 0:
                continue
            il = lvl
            if fr.sharpness > 0:
                il >>= 2 if fr.sharpness > 4 else 1
                il = min(il, 9 - fr.sharpness)
            il = max(il, 1)
            m = (fr.segment == s) & (fr.is_i4 == i4)
            limit[m] = 2 * lvl + il
            ilev[m] = il
            hev[m] = 2 if lvl >= 40 else 1 if lvl >= 15 else 0
    return limit, ilev, hev, inner


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _filter(p, thresh2, ithresh, hev_t, on, kind, tally=None):
    """Filter lines p (M, L, 8) = p3 p2 p1 p0 q0 q1 q2 q3 across one edge.
    kind: 'mb' (6-tap where no high edge variance), 'inner' (4-tap) or
    'simple'.  Per-lane parameters are (M,) arrays; ``on`` masks lanes.
    ``tally[kind]`` gains the lines tested, those that pass the threshold
    tests and, of those, the ones with high edge variance."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (p[..., i] for i in range(8))
    t2 = thresh2[:, None]
    need = ((4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= t2) & on[:, None]
    out = p.copy()
    if kind == "simple":
        if tally is not None:
            _count(tally, kind, int(on.sum()) * p.shape[1], need, None)
        a = 3 * (q0 - p0) + _sclip1(p1 - q1)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        out[..., 3] = np.where(need, np.clip(p0 + a2, 0, 255), p0)
        out[..., 4] = np.where(need, np.clip(q0 - a1, 0, 255), q0)
        return out
    it = ithresh[:, None]
    for x, y in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        need &= np.abs(x - y) <= it
    ht = hev_t[:, None]
    hev = (np.abs(p1 - p0) > ht) | (np.abs(q1 - q0) > ht)
    # high edge variance: the 2-tap filter
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    f2p0, f2q0 = np.clip(p0 + a2, 0, 255), np.clip(q0 - a1, 0, 255)
    m2 = need & hev
    mo = need & ~hev
    if tally is not None:
        _count(tally, kind, int(on.sum()) * p.shape[1], need, m2)
    out[..., 3] = np.where(m2, f2p0, out[..., 3])
    out[..., 4] = np.where(m2, f2q0, out[..., 4])
    if kind == "mb":
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        new = {1: p2 + a3, 2: p1 + a2, 3: p0 + a1, 4: q0 - a1, 5: q1 - a2,
               6: q2 - a3}
    else:
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        new = {2: p1 + a3, 3: p0 + a2, 4: q0 - a1, 5: q1 - a3}
    for i, v in new.items():
        out[..., i] = np.where(mo, np.clip(v, 0, 255), out[..., i])
    return out


def _count(tally, kind, tested, need, high):
    t = tally.setdefault(kind, [0, 0, 0])
    t[0] += tested
    t[1] += int(need.sum())
    t[2] += 0 if high is None else int(high.sum())


def _edge(P, rows, cols, vertical, n, thresh2, ithresh, hev_t, on, kind,
          tally=None):
    """Filter an edge of n lines for the lanes that ``on`` selects.
    vertical: an edge between columns (its lines cross it horizontally) at
    ``cols``, starting at ``rows``; else an edge between rows."""
    if not on.any():
        return
    rows, cols = rows[on], cols[on]
    k = np.arange(8) - 4
    j = np.arange(n)
    if vertical:
        ri = rows[:, None, None] + j[None, :, None]
        ci = cols[:, None, None] + k[None, None, :]
    else:
        ri = rows[:, None, None] + k[None, None, :]
        ci = cols[:, None, None] + j[None, :, None]
    ri, ci = np.broadcast_arrays(ri, ci)
    P[ri, ci] = _filter(P[ri, ci], thresh2[on], ithresh[on], hev_t[on],
                        np.ones(len(rows), bool), kind, tally)


def loop_filter(fr: Frame, Y, U, V, nonzero, tally=None):
    """Filter the planes in place, macroblock by macroblock in an order
    equivalent to raster order.  ``tally`` (a dict) gains, for each kind of
    edge ('mb', 'inner', 'simple'), [lines tested, lines that pass the
    threshold tests, of those the lines with high edge variance]."""
    if fr.level == 0:
        return
    limit, ilev, hevt, inner = filter_params(fr, nonzero)
    simple = fr.simple == 1
    for mx, my in _waves(fr.mb_w, fr.mb_h):
        lim = limit[my, mx]
        act = lim > 0
        if not act.any():
            continue
        mx, my, lim = mx[act], my[act], lim[act]
        il, ht, inn = ilev[my, mx], hevt[my, mx], inner[my, mx]
        mbt, int2 = 2 * (lim + 4) + 1, 2 * lim + 1
        yr, xc = 16 * my, 16 * mx
        cr, cc = 8 * my, 8 * mx
        if simple:
            _edge(Y, yr, xc, True, 16, mbt, il, ht, mx > 0, "simple", tally)
            for d in (4, 8, 12):
                _edge(Y, yr, xc + d, True, 16, int2, il, ht, inn, "simple",
                      tally)
            _edge(Y, yr, xc, False, 16, mbt, il, ht, my > 0, "simple", tally)
            for d in (4, 8, 12):
                _edge(Y, yr + d, xc, False, 16, int2, il, ht, inn, "simple",
                      tally)
            continue
        _edge(Y, yr, xc, True, 16, mbt, il, ht, mx > 0, "mb", tally)
        for P in (U, V):
            _edge(P, cr, cc, True, 8, mbt, il, ht, mx > 0, "mb", tally)
        for d in (4, 8, 12):
            _edge(Y, yr, xc + d, True, 16, int2, il, ht, inn, "inner", tally)
        for P in (U, V):
            _edge(P, cr, cc + 4, True, 8, int2, il, ht, inn, "inner", tally)
        _edge(Y, yr, xc, False, 16, mbt, il, ht, my > 0, "mb", tally)
        for P in (U, V):
            _edge(P, cr, cc, False, 8, mbt, il, ht, my > 0, "mb", tally)
        for d in (4, 8, 12):
            _edge(Y, yr + d, xc, False, 16, int2, il, ht, inn, "inner", tally)
        for P in (U, V):
            _edge(P, cr + 4, cc, False, 8, int2, il, ht, inn, "inner", tally)
