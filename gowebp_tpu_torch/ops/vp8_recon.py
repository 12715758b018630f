"""VP8 intra prediction and the decode's reconstruction engine.

Shared with the encode paths: all 10 B-mode (4x4 luma) predictions of a
sub-block (the 8 shift-composable B-modes are integer indexing into one
shared feature vector), the whole-block DC/TM/VE/HE predictions and
their per-MB context read from a plane, and the anti-diagonal count of
the macroblock wavefront.

The decode (``recon_frame``): dense per-MB symbols from the host →
reconstructed, loop-filtered uint8 planes.  On a CUDA tensor it runs the
``recon_filter_mb`` kernel (ops/kernels/vp8_recon.py), which filters each
MB right after its recon; on a CPU tensor, and as that kernel's
reference, the plain torch ops here:

- the iDCT of every residual block at once;
- intra prediction as an MB anti-diagonal wavefront (slope 2:
  t = 2*mb_y + mb_x, which honours the top-right dependency), the 16
  luma sub-blocks of i4 MBs in raster order inside each step;
- the in-loop deblocking filter over the same schedule, run on the
  complete unfiltered reconstruction (prediction reads unfiltered
  pixels, so the filter waits for the whole frame).

The planes stay in raster layout, int32, with a 4-pixel border: 4 rows
on top, 4 columns on the left and 4 on the right.  Each step gathers
and scatters its diagonal's MBs by flat index.  The border carries the
intra edge fills (127 on the row above the frame, 129 on the column to
its left), so prediction reads them like any neighbour.  The filter's
windows reach 4 pixels up and left into it, under edges that its masks
keep off.

Written from RFC 6386 §12-15; bit-identical to the JAX package's engine
and to libwebp.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dct

I32 = torch.int32
PAD = 4   # plane border: rows above, columns left and right


def _b4_index_tables() -> np.ndarray:
    """Static lookup tables for the 8 shift-composable B-mode predictors.

    Context vector Z = [L, L, K, J, I, X, A, B, C, D, E, F, G, H, H]
    (15 entries; the duplicated L/H endpoints make every avg3 the
    predictors use a *consecutive* triple).  The feature vector is
    [Z (15) | avg2 of consecutive pairs (14) | avg3 of consecutive
    triples (13)] = 42 entries; each predictor's 16 output pixels are a
    static index into it.  Modes in libwebp order VE, HE, RD, VR, LD,
    VL, HD, HU (B-modes 2..9).
    """
    Zi = {"L": 1, "K": 2, "J": 3, "I": 4, "X": 5, "A": 6, "B": 7,
          "C": 8, "D": 9, "E": 10, "F": 11, "G": 12, "H": 13}

    def a2(n1, n2):
        i, j = sorted((Zi[n1], Zi[n2]))
        assert j == i + 1, (n1, n2)
        return 15 + i

    def a3(n1, n2, n3):
        c = Zi[n2]
        lo, hi = sorted((Zi[n1], Zi[n3]))
        # duplicated endpoints: avg3(K,L,L) = triple (0,1,2), avg3(G,H,H)
        # = triple (12,13,14)
        assert (lo, hi) == (c - 1, c + 1) or \
            (n3 == n2 and Zi[n1] in (c - 1, c + 1)), (n1, n2, n3)
        return 15 + 14 + (c - 1)

    ve = [a3("X", "A", "B"), a3("A", "B", "C"), a3("B", "C", "D"),
          a3("C", "D", "E")]
    p_ve = [ve, ve, ve, ve]
    he = [a3("X", "I", "J"), a3("I", "J", "K"), a3("J", "K", "L"),
          a3("K", "L", "L")]
    p_he = [[h] * 4 for h in he]

    dcb = a3("D", "C", "B")
    cba = a3("C", "B", "A")
    bax = a3("B", "A", "X")
    axi = a3("A", "X", "I")
    xij = a3("X", "I", "J")
    ijk = a3("I", "J", "K")
    jkl = a3("J", "K", "L")
    p_rd = [[axi, bax, cba, dcb],
            [xij, axi, bax, cba],
            [ijk, xij, axi, bax],
            [jkl, ijk, xij, axi]]

    xa, ab, bc, cd, de = (a2("X", "A"), a2("A", "B"), a2("B", "C"),
                          a2("C", "D"), a2("D", "E"))
    kji = a3("K", "J", "I")
    jix = a3("J", "I", "X")
    ixa = a3("I", "X", "A")
    xab = a3("X", "A", "B")
    abc = a3("A", "B", "C")
    bcd = a3("B", "C", "D")
    p_vr = [[xa, ab, bc, cd],
            [ixa, xab, abc, bcd],
            [jix, xa, ab, bc],
            [kji, ixa, xab, abc]]

    cde = a3("C", "D", "E")
    def_ = a3("D", "E", "F")
    efg = a3("E", "F", "G")
    fgh = a3("F", "G", "H")
    ghh = a3("G", "H", "H")
    p_ld = [[abc, bcd, cde, def_],
            [bcd, cde, def_, efg],
            [cde, def_, efg, fgh],
            [def_, efg, fgh, ghh]]

    p_vl = [[ab, bc, cd, de],
            [abc, bcd, cde, def_],
            [bc, cd, de, efg],
            [bcd, cde, def_, fgh]]

    ix, ji, kj, lk = (a2("I", "X"), a2("J", "I"), a2("K", "J"),
                      a2("L", "K"))
    p_hd = [[ix, ixa, xab, abc],
            [ji, xij, ix, ixa],
            [kj, ijk, ji, xij],
            [lk, jkl, kj, ijk]]

    ij, jk, kl = a2("I", "J"), a2("J", "K"), a2("K", "L")
    jkl3 = a3("J", "K", "L")
    kll = a3("K", "L", "L")
    Lz = Zi["L"]
    p_hu = [[ij, ijk, jk, jkl3],
            [jk, jkl3, kl, kll],
            [kl, kll, Lz, Lz],
            [Lz, Lz, Lz, Lz]]

    return np.array([p_ve, p_he, p_rd, p_vr, p_ld, p_vl, p_hd, p_hu],
                    np.int64)


_B4_IDX = _b4_index_tables()                       # (8, 4, 4)


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred_luma4_all(tl, top, tr, left):
    """All 10 B-mode predictions of a 4x4 block.

    tl (...), top/tr/left (..., 4) int32 → (..., 10, 4, 4) int32, in
    libwebp enum order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU.
    """
    tl, top, tr, left = (a.to(I32) for a in (tl, top, tr, left))
    lead = tl.shape
    # Z = [L, L, K, J, I, X, A, B, C, D, E, F, G, H, H]
    Z = torch.cat(
        [left[..., 3:4], left.flip(-1), tl[..., None], top, tr,
         tr[..., 3:4]], dim=-1)                     # (..., 15)
    feat = torch.cat([Z, _avg2(Z[..., :-1], Z[..., 1:]),
                      _avg3(Z[..., :-2], Z[..., 1:-1], Z[..., 2:])], dim=-1)
    idx = torch.as_tensor(_B4_IDX.reshape(-1), device=feat.device)
    preds8 = feat[..., idx].reshape(lead + (8, 4, 4))
    dc = (top.sum(-1, dtype=I32) + left.sum(-1, dtype=I32) + 4) >> 3
    p_dc = dc[..., None, None].expand(lead + (4, 4))
    p_tm = torch.clamp(
        left[..., :, None] + top[..., None, :] - tl[..., None, None], 0, 255)
    return torch.cat(
        [p_dc[..., None, :, :], p_tm[..., None, :, :], preds8], dim=-3)


def predict4_blocks(top, left, tl, have_top, have_left, size: int):
    """Whole-block DC/TM/VE/HE predictions of 16x16 luma or 8x8 chroma.

    top/left (..., size), tl (...), have_top/have_left bool (...) →
    (4, ..., size, size) int32 in mode order DC, TM, VE, HE.
    """
    shift = 5 if size == 16 else 4
    sum_top = top.sum(-1, dtype=I32)
    sum_left = left.sum(-1, dtype=I32)
    dc_both = (sum_top + sum_left + size) >> shift
    dc_left = (sum_left + size // 2) >> (shift - 1)
    dc_top = (sum_top + size // 2) >> (shift - 1)
    dc = torch.where(
        have_top & have_left, dc_both,
        torch.where(have_left, dc_left, torch.where(have_top, dc_top, 0x80)))
    shape = top.shape + (size,)
    pred_dc = dc[..., None, None].expand(shape)
    pred_tm = torch.clamp(
        left[..., :, None] + top[..., None, :] - tl[..., None, None], 0, 255)
    pred_ve = top[..., None, :].expand(shape)
    pred_he = left[..., :, None].expand(shape)
    return torch.stack([pred_dc, pred_tm.to(I32), pred_ve, pred_he])


def mb_context(cy, mh, mw, size, left_halo=None):
    """Plane (B, H, W) → per-MB top/left/top-left context (B, N, ...).

    Edge rules of the intra encoders: the top MB row reads 127
    (corner included), the left MB column 129; the top-right 4 pixels
    of the last MB column repeat the row above's last pixel.
    ``left_halo`` (B, H), the column left of the plane (a width tile's
    left neighbour's last column): the MB column 0 reads its left and
    corner from it and has a left neighbour.
    Returns (top (B,N,s), tr4 (B,N,4) [luma only, else None],
    left (B,N,s), tl (B,N)) with the edge fills applied, plus the (N,)
    have_top/have_left masks.
    """
    B = cy.shape[0]
    dev = cy.device
    my = torch.arange(mh, device=dev)
    mx = torch.arange(mw, device=dev)
    row_above = cy[:, (size * my - 1).clamp_min(0)]            # (B, mh, W)
    top = row_above.reshape(B, mh, mw, size)
    col_left = cy[:, :, (size * mx - 1).clamp_min(0)]          # (B, H, mw)
    tl = row_above[:, :, (size * mx - 1).clamp_min(0)]         # (B, mh, mw)
    hl = mx > 0
    if left_halo is not None:
        halo = left_halo.to(cy.dtype)
        col_left[:, :, 0] = halo
        tl[:, :, 0] = halo[:, (size * my - 1).clamp_min(0)]
        hl = torch.ones_like(hl)
    left = col_left.reshape(B, mh, size, mw).transpose(2, 3)
    ht = (my > 0)[:, None].expand(mh, mw).reshape(-1)
    hl = hl[None, :].expand(mh, mw).reshape(-1)
    top = torch.where(ht[:, None], top.reshape(B, -1, size), 127)
    left = torch.where(hl[:, None], left.reshape(B, -1, size), 129)
    tl = torch.where(ht, torch.where(hl, tl.reshape(B, -1), 129), 127)
    tr4 = None
    if size == 16:
        cols = size * (mx[:, None] + 1) + torch.arange(4, device=dev)
        tr4 = row_above[:, :, cols.clamp_max(size * mw - 1)]   # (B,mh,mw,4)
        last = (mx == mw - 1)[None, :].expand(mh, mw).reshape(-1)
        tr4 = torch.where(last[:, None], top[:, :, 15:16],
                          tr4.reshape(B, -1, 4))
        tr4 = torch.where(ht[:, None], tr4, 127)
    return top, tr4, left, tl, ht, hl


def num_diagonals(mb_w: int, mb_h: int) -> int:
    """Wavefront steps of an mb_w x mb_h frame (t = 2*mb_y + mb_x)."""
    return (mb_w - 1) + 2 * (mb_h - 1) + 1


# ---------------------------------------------------------------------------
# Decode: residuals
# ---------------------------------------------------------------------------

def idct4x4_batch(coeffs):
    """(..., 16) raster dequantized coefficients → (..., 4, 4) residual
    (the +4 rounding and >>3 included; a zero block gives zero)."""
    return dct.idct4x4(coeffs.reshape(coeffs.shape[:-1] + (4, 4)))


def residual_blocks(coeffs):
    """(B, N, 24, 16) int coeffs → per-MB residual blocks.

    Returns (Yres (B,N,16,16), Ures (B,N,8,8), Vres (B,N,8,8)) int32.
    Luma sub-block n sits at rows 4*(n>>2), cols 4*(n&3); each chroma
    plane's 4 blocks are a raster 2x2 grid.
    """
    B, N = coeffs.shape[0], coeffs.shape[1]
    res = idct4x4_batch(coeffs)                      # (B, N, 24, 4, 4)
    ly = res[:, :, :16].reshape(B, N, 4, 4, 4, 4)
    Yres = ly.permute(0, 1, 2, 4, 3, 5).reshape(B, N, 16, 16)
    cu = res[:, :, 16:20].reshape(B, N, 2, 2, 4, 4)
    Ures = cu.permute(0, 1, 2, 4, 3, 5).reshape(B, N, 8, 8)
    cv = res[:, :, 20:24].reshape(B, N, 2, 2, 4, 4)
    Vres = cv.permute(0, 1, 2, 4, 3, 5).reshape(B, N, 8, 8)
    return Yres, Ures, Vres


# ---------------------------------------------------------------------------
# Decode: the diagonal schedule
# ---------------------------------------------------------------------------

class Diagonals:
    """The slope-2 wavefront of an mb_w x mb_h frame, as flat indices.

    MBs are listed diagonal by diagonal (t = 2*mb_y + mb_x, mb_y rising
    within a diagonal); ``spans()`` gives each diagonal's slice of that
    list.  The index tensors are built once per frame shape on the
    device; every step only slices them.  ``top``: the frame is a stripe
    below another, so its MB row 0 has a row above too.
    """

    def __init__(self, mb_w: int, mb_h: int, device, top: bool = False):
        self.mb_w, self.mb_h = mb_w, mb_h
        ys, offs = [], [0]
        for t in range(num_diagonals(mb_w, mb_h)):
            lo = max(0, -(-(t - mb_w + 1) // 2))
            hi = min(mb_h - 1, t // 2)
            ys.append(np.arange(lo, hi + 1))
            offs.append(offs[-1] + hi + 1 - lo)
        my = np.concatenate(ys)
        t_of = np.repeat(np.arange(len(ys)), np.diff(offs))
        mx = t_of - 2 * my
        self.offs = offs
        self.my = torch.as_tensor(my, dtype=torch.int64, device=device)
        self.mx = torch.as_tensor(mx, dtype=torch.int64, device=device)
        self.mb = self.my * mb_w + self.mx                 # flat MB index
        self.has_top = (self.my > 0) | top
        self.has_left = self.mx > 0
        self.last_col = self.mx == mb_w - 1

    def spans(self):
        """Slices of the non-empty diagonals, in order (a frame one MB
        wide has empty odd diagonals)."""
        return [slice(a, b) for a, b in zip(self.offs, self.offs[1:])
                if b > a]


def _plane_index(rows, cols, row0, col0, stride):
    """Flat indices into a bordered plane of the (len(rows), len(cols))
    window at pixel (row0, col0) of each MB: (n, R, C) int64."""
    rows = torch.tensor(list(rows), dtype=torch.int64, device=row0.device)
    cols = torch.tensor(list(cols), dtype=torch.int64, device=row0.device)
    r = (row0 + PAD)[:, None, None] + rows[:, None]
    c = (col0 + PAD)[:, None, None] + cols[None, :]
    return r * stride + c


def _bordered(B: int, h: int, w: int, device):
    """(B, PAD + h, PAD + w + PAD) int32 plane with the intra edge fills:
    127 on the row above the frame (and the corner), 129 on the column to
    its left."""
    P = torch.zeros((B, PAD + h, PAD + w + PAD), dtype=I32, device=device)
    P[:, PAD:, PAD - 1] = 129
    P[:, PAD - 1, :] = 127
    return P


def _select(preds, mode):
    """preds (K, ...) stacked candidates, mode (...) int → (...)."""
    trail = (1,) * (preds.dim() - 1 - mode.dim())
    idx = mode.to(torch.int64).reshape((1,) + mode.shape + trail)
    return preds.gather(0, idx.expand((1,) + preds.shape[1:]))[0]


# ---------------------------------------------------------------------------
# Decode: reconstruction wavefront
# ---------------------------------------------------------------------------

def recon_wavefront(Yres, Ures, Vres, is_i4, imodes, uvmode, dg: Diagonals,
                    above=None):
    """Intra-predict + add residuals over the MB anti-diagonal wavefront.

    Inputs are per-MB tensors (B, N, ...) (N = mb_h*mb_w, raster order);
    returns the bordered int32 planes (PY (B, PAD+16*mb_h, 16*mb_w+2*PAD),
    PC (2B, PAD+8*mb_h, 8*mb_w+2*PAD), U then V on the batch axis).
    ``above`` (a stripe below another: ``dg`` built with ``top``) = (the
    stripe above's unfiltered bottom luma row (B, 16*mb_w), its chroma
    rows (2B, 8*mb_w), U then V) takes the border row's 127 fill, and the
    corner left of it reads 129, as inside a frame.
    """
    B, dev = Yres.shape[0], Yres.device
    H, W = 16 * dg.mb_h, 16 * dg.mb_w
    PY = _bordered(B, H, W, dev)
    PC = _bordered(2 * B, H // 2, W // 2, dev)
    if above is not None:
        for P, row in zip((PY, PC), above):
            P[:, PAD - 1, PAD:PAD + row.shape[1]] = row.to(I32)
            P[:, PAD - 1, PAD - 1] = 129
    sy, sc = PY.shape[2], PC.shape[2]
    PYf, PCf = PY.view(B, -1), PC.view(2 * B, -1)
    r16, c16 = 16 * dg.my, 16 * dg.mx
    # context row (tl, top 16, top-right 4), left column, interior
    y_top = _plane_index([-1], range(-1, 20), r16, c16, sy)[:, 0]
    y_left = _plane_index(range(16), [-1], r16, c16, sy)[:, :, 0]
    y_in = _plane_index(range(16), range(16), r16, c16, sy)
    c_top = _plane_index([-1], range(-1, 8), r16 // 2, c16 // 2, sc)[:, 0]
    c_left = _plane_index(range(8), [-1], r16 // 2, c16 // 2, sc)[:, :, 0]
    c_in = _plane_index(range(8), range(8), r16 // 2, c16 // 2, sc)
    Cres = torch.cat([Ures, Vres], dim=0)
    is_i4, imodes, uvmode = is_i4.to(I32), imodes.to(I32), uvmode.to(I32)

    for sl in dg.spans():
        mb = dg.mb[sl]
        ht, hl = dg.has_top[sl], dg.has_left[sl]
        n = mb.shape[0]

        # ---- luma: the i16 prediction of the whole MB ----
        ctx = PYf[:, y_top[sl]]                             # (B,n,21)
        top = ctx[..., 1:17]
        # the last column's top-right context repeats the top row's end
        tr = torch.where(dg.last_col[sl][:, None], top[..., 15:16],
                         ctx[..., 17:21])
        left = PYf[:, y_left[sl]]                           # (B,n,16)
        im = imodes[:, mb]                                  # (B,n,16)
        yres = Yres[:, mb]                                  # (B,n,16,16)
        preds = predict4_blocks(top, left, ctx[..., 0], ht, hl, 16)
        # (an i4 MB's first B-mode may exceed 3; its i16 block is unused)
        ymode = torch.clamp_max(im[..., 0], 3)
        blk = torch.clamp(_select(preds, ymode) + yres, 0, 255)

        # ---- luma: i4 sub-blocks in raster order, in a 17x21 scratch
        # whose row 0 / col 0 hold the MB's context ----
        scr = torch.cat([
            torch.cat([ctx[..., :17], tr], -1)[:, :, None],
            torch.cat([left[..., None], blk,
                       blk.new_zeros((B, n, 16, 4))], -1)], dim=2)
        is4 = (is_i4[:, mb] > 0)[..., None, None]
        for k in range(16):
            r, c = 4 * (k >> 2), 4 * (k & 3)
            tr4 = scr[:, :, 0, 17:21] if c == 12 else scr[:, :, r, c + 5:c + 9]
            p10 = _pred_luma4_all(scr[:, :, r, c], scr[:, :, r, c + 1:c + 5],
                                  tr4, scr[:, :, r + 1:r + 5, c])
            sub = torch.clamp(
                _select(p10.movedim(2, 0), im[..., k])
                + yres[:, :, r:r + 4, c:c + 4], 0, 255)
            cur = scr[:, :, r + 1:r + 5, c + 1:c + 5]
            scr[:, :, r + 1:r + 5, c + 1:c + 5] = torch.where(is4, sub, cur)
        PYf[:, y_in[sl]] = scr[:, :, 1:17, 1:17]

        # ---- chroma: U and V stacked on the batch axis ----
        cctx = PCf[:, c_top[sl]]                            # (2B,n,9)
        cleft = PCf[:, c_left[sl]]
        cm = uvmode[:, mb].repeat(2, 1)
        cpred = predict4_blocks(cctx[..., 1:9], cleft, cctx[..., 0], ht, hl, 8)
        PCf[:, c_in[sl]] = torch.clamp(_select(cpred, cm) + Cres[:, mb], 0, 255)
    return PY, PC


# ---------------------------------------------------------------------------
# Decode: loop filter (RFC 6386 §15)
# ---------------------------------------------------------------------------

def _lanes_complex(S, thresh2, it, hev_t, edge: bool):
    """Complex filter on (B, n, L, 8) strips [p3..p0, q0..q3] across an
    edge; thresh2/it/hev_t (B, n).  ``edge``: macroblock edge (hev ?
    filter2 : filter6) or inner edge (hev ? filter2 : filter4)."""
    p3, p2, p1, p0 = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    q0, q1, q2, q3 = S[..., 4], S[..., 5], S[..., 6], S[..., 7]
    t2, itl, hv_t = thresh2[..., None], it[..., None], hev_t[..., None]
    ab = torch.abs
    nf = (4 * ab(p0 - q0) + ab(p1 - q1)) <= t2
    nf &= (ab(p3 - p2) <= itl) & (ab(p2 - p1) <= itl)
    nf &= (ab(p1 - p0) <= itl) & (ab(q3 - q2) <= itl)
    nf &= (ab(q2 - q1) <= itl) & (ab(q1 - q0) <= itl)
    hv = (ab(p1 - p0) > hv_t) | (ab(q1 - q0) > hv_t)

    def sclip1(v):
        return torch.clamp(v, -128, 127)

    def sclip2(v):
        return torch.clamp(v, -16, 15)

    def clip8(v):
        return torch.clamp(v, 0, 255)

    # filter2 (hev path): modifies p0, q0.
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    f2_p0 = clip8(p0 + sclip2((a + 3) >> 3))
    f2_q0 = clip8(q0 - sclip2((a + 4) >> 3))
    if edge:
        # filter6: modifies p2..q2.
        w = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
        b1 = (27 * w + 63) >> 7
        b2 = (18 * w + 63) >> 7
        b3 = (9 * w + 63) >> 7
        n_p2, n_q2 = clip8(p2 + b3), clip8(q2 - b3)
        n_p1, n_q1 = clip8(p1 + b2), clip8(q1 - b2)
        n_p0, n_q0 = clip8(p0 + b1), clip8(q0 - b1)
    else:
        # filter4: modifies p1..q1.
        w = 3 * (q0 - p0)
        b1 = sclip2((w + 4) >> 3)
        b2 = sclip2((w + 3) >> 3)
        b3 = (b1 + 1) >> 1
        n_p2, n_q2 = p2, q2
        n_p1, n_q1 = clip8(p1 + b3), clip8(q1 - b3)
        n_p0, n_q0 = clip8(p0 + b2), clip8(q0 - b1)
    soft = nf & ~hv
    return torch.stack([
        p3, torch.where(soft, n_p2, p2), torch.where(soft, n_p1, p1),
        torch.where(nf, torch.where(hv, f2_p0, n_p0), p0),
        torch.where(nf, torch.where(hv, f2_q0, n_q0), q0),
        torch.where(soft, n_q1, q1), torch.where(soft, n_q2, q2), q3], dim=-1)


def _lanes_simple(S, thresh2):
    """Simple filter on (B, n, L, 4) strips [p1, p0, q0, q1] (luma only)."""
    p1, p0, q0, q1 = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    nf = (4 * torch.abs(p0 - q0) + torch.abs(p1 - q1)) <= thresh2[..., None]
    a = 3 * (q0 - p0) + torch.clamp(p1 - q1, -128, 127)
    o_p0 = torch.clamp(p0 + torch.clamp((a + 3) >> 3, -16, 15), 0, 255)
    o_q0 = torch.clamp(q0 - torch.clamp((a + 4) >> 3, -16, 15), 0, 255)
    return torch.stack([p1, torch.where(nf, o_p0, p0),
                        torch.where(nf, o_q0, q0), q1], dim=-1)


def _filter_strips(wins, vertical: bool, at: int, lo: int, hi: list,
                   params, mask, edge: bool, simple: bool):
    """Filter one edge of each window in ``wins`` (a list of (B, n, R, C)
    windows whose lanes run together through one filter call), in place.

    ``vertical``: the edge is the column ``at`` (lanes are rows lo:hi[i]);
    else the row ``at`` (lanes are columns lo:hi[i]).
    """
    thresh2, it, hev_t = params
    K = 2 if simple else 4
    strips = [(w[:, :, lo:h, at - K:at + K] if vertical
               else w[:, :, at - K:at + K, lo:h].transpose(-1, -2))
              for w, h in zip(wins, hi)]
    S = torch.cat(strips, dim=2) if len(strips) > 1 else strips[0]
    out = (_lanes_simple(S, thresh2) if simple
           else _lanes_complex(S, thresh2, it, hev_t, edge))
    out = torch.where(mask[..., None, None], out, S)
    o = 0
    for w, h in zip(wins, hi):
        part = out[:, :, o:o + h - lo]
        o += h - lo
        if vertical:
            w[:, :, lo:h, at - K:at + K] = part
        else:
            w[:, :, at - K:at + K, lo:h] = part.transpose(-1, -2)


def loop_filter_wavefront(PY, PC, fparams, dg: Diagonals, filter_type: int):
    """In-loop deblocking of the bordered planes, in place, over the same
    slope-2 wavefront (an MB's filter reads what its left, top and
    top-right neighbours' filters wrote).

    fparams: int (B, mb_h, mb_w, 4) = [limit, ilevel, hev_t, inner];
    limit < 0 disables the MB.  filter_type: 0 = none, 1 = simple (luma
    only), 2 = complex (luma + chroma).  Per plane the edges go in
    libwebp's order: left MB edge, inner vertical edges, top MB edge,
    inner horizontal edges.
    """
    if filter_type == 0:
        return PY, PC
    B = PY.shape[0]
    simple = filter_type == 1
    sy, sc = PY.shape[2], PC.shape[2]
    PYf, PCf = PY.view(B, -1), PC.view(2 * B, -1)
    r16, c16 = 16 * dg.my, 16 * dg.mx
    # windows reach 4 pixels up and left of the MB
    y_win = _plane_index(range(-4, 16), range(-4, 16), r16, c16, sy)
    c_win = _plane_index(range(-4, 8), range(-4, 8), r16 // 2, c16 // 2, sc)
    fp = fparams.to(I32).reshape(B, dg.mb_h * dg.mb_w, 4)

    for sl in dg.spans():
        mb = dg.mb[sl]
        par = fp[:, mb]                                     # (B,n,4)
        limit, il, hev_t = par[..., 0], par[..., 1], par[..., 2]
        on = limit >= 0
        m_left = on & dg.has_left[sl]
        m_top = on & dg.has_top[sl]
        m_inner = on & (par[..., 3] > 0)
        pe = (2 * limit + 1, il, hev_t)                    # inner edges
        pm = (2 * (limit + 4) + 1, il, hev_t)              # MB edges

        w = PYf[:, y_win[sl]]                               # (B,n,20,20)
        if simple:
            _filter_strips([w], True, 4, 4, [20], pm, m_left, True, True)
            for d in (8, 12, 16):
                _filter_strips([w], True, d, 4, [20], pe, m_inner, False, True)
            _filter_strips([w], False, 4, 4, [20], pm, m_top, True, True)
            for d in (8, 12, 16):
                _filter_strips([w], False, d, 4, [20], pe, m_inner, False, True)
            PYf[:, y_win[sl]] = w
            continue

        # complex: luma and chroma are independent planes, so one filter
        # call carries the same edge of all three (and the chroma inner
        # edges ride with the first luma inner edge)
        cw = PCf[:, c_win[sl]]                              # (2B,n,12,12)
        u, v = cw[:B], cw[B:]
        yuv, hi = [w, u, v], [20, 12, 12]
        _filter_strips(yuv, True, 4, 4, hi, pm, m_left, True, False)
        _filter_strips(yuv, True, 8, 4, hi, pe, m_inner, False, False)
        for d in (12, 16):
            _filter_strips([w], True, d, 4, [20], pe, m_inner, False, False)
        _filter_strips(yuv, False, 4, 4, hi, pm, m_top, True, False)
        _filter_strips(yuv, False, 8, 4, hi, pe, m_inner, False, False)
        for d in (12, 16):
            _filter_strips([w], False, d, 4, [20], pe, m_inner, False, False)
        PYf[:, y_win[sl]] = w
        PCf[:, c_win[sl]] = cw
    return PY, PC


# ---------------------------------------------------------------------------
# Decode: full frame
# ---------------------------------------------------------------------------

def crop_planes(PY, PC, mb_w: int):
    """Bordered int32 planes (PY (B, ...), PC (2B, ...): U then V) →
    contiguous uint8 planes (B, 16*mb_h, 16*mb_w), (B, 8*mb_h, 8*mb_w) x2."""
    B, W = PY.shape[0], 16 * mb_w
    Y = PY[:, PAD:, PAD:PAD + W].to(torch.uint8).contiguous()
    C = PC[:, PAD:, PAD:PAD + W // 2].to(torch.uint8)
    return Y, C[:B].contiguous(), C[B:].contiguous()


def recon_frame(coeffs, is_i4, imodes, uvmode, fparams, *, mb_w, mb_h,
                filter_type, marks=None):
    """Dequantized symbols → reconstructed + filtered uint8 planes.

    coeffs (B, N, 24, 16) int16 (int16 or int32 on the CPU); is_i4/uvmode
    (B, N) int; imodes (B, N, 16) int; fparams (B, mb_h, mb_w, 4) int.
    Returns contiguous uint8 planes (B, 16*mb_h, 16*mb_w), (B, 8*mb_h,
    8*mb_w) x2.  On a CUDA tensor the one ``recon_filter_mb`` kernel runs
    (ops/kernels/vp8_recon.py); on a CPU tensor the plain torch loops
    above.  ``marks(name)``, if given, is called after each stage: on the
    card "recon" alone (the kernel's iDCT, recon and filter); on the CPU
    "idct", "recon" and "filter" (which includes the store to uint8).
    """
    if coeffs.device.type == "cuda":
        from .kernels.vp8_recon import pack_modes, recon_filter_mb

        planes = recon_filter_mb(coeffs, pack_modes(is_i4, imodes, uvmode),
                                 fparams, mb_w, mb_h, filter_type)
        if marks is not None:
            marks("recon")
        return planes
    if coeffs.device.type != "cpu":
        raise ValueError(f"recon_frame: unsupported device {coeffs.device}")
    dg = Diagonals(mb_w, mb_h, coeffs.device)
    Yres, Ures, Vres = residual_blocks(coeffs.to(I32))
    if marks is not None:
        marks("idct")
    PY, PC = recon_wavefront(Yres, Ures, Vres, is_i4, imodes, uvmode, dg)
    if marks is not None:
        marks("recon")
    loop_filter_wavefront(PY, PC, fparams, dg, filter_type)
    planes = crop_planes(PY, PC, mb_w)
    if marks is not None:
        marks("filter")
    return planes


__all__ = ["Diagonals", "_pred_luma4_all", "crop_planes", "idct4x4_batch",
           "loop_filter_wavefront", "mb_context", "num_diagonals",
           "predict4_blocks", "recon_frame", "recon_wavefront",
           "residual_blocks"]
