"""Fixed-mode wavefront: the Hopper kernel, its binding and its plain version.

``wavefront_fixed`` encodes every macroblock of a batch with the modes
given (the hybrid encoder's phase 2): i16 predict → FDCT → FWHT →
quantize → dequantize → IWHT → IDCT → recon, or the 16-sub-block i4
chain, plus 8x8 chroma with optional UV DC error diffusion — exactly
closed-loop, in wavefront order.  On a CUDA tensor it runs the kernel in
``wavefront_fixed.cu`` (replacing the TPU kernel
gowebp_tpu/ops/pallas/wavefront_fixed.py), one persistent launch whose
blocks own MB rows and wait on the row above's progress counter; on a
CPU tensor it runs ``wavefront_fixed_plain``, a per-diagonal torch loop
with the same arithmetic.  That loop, ``wavefront_plain``, takes its
decisions from a decider: ``GivenModes`` reads them from the inputs, the
exact engine's search (ops/kernels/wavefront_search.py) makes them
inside the loop.

Inputs: y (B, H, W) uint8 and u, v (B, H/2, W/2) uint8 with H, W
multiples of 16; seg, ymode, uvmode, is_i4 (B, mh, mw) int32; imodes
(B, mh, mw, 16) int32; qsteps (B, 4, 6) int32.  Returns int16 zigzag
levels y_levels (B, mh, mw, 16, 16), y2_levels (B, mh, mw, 16),
uv_levels (B, mh, mw, 8, 16), and with ``want_recon`` the uint8 recon
planes recon_y/recon_u/recon_v.
"""

from __future__ import annotations

import ctypes

import torch

from ..dct import (BIAS, dequantize, fdct4x4, fwht4x4, idct_add_clip,
                   iwht4x4, quantize)
from ..rate import trellis_refine
from ..vp8_recon import _pred_luma4_all, num_diagonals, predict4_blocks
from .cuda_build import CudaLibrary, check_tensor, stream_handle

I32 = torch.int32


def _configure(lib) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.wavefront_fixed_launch.restype = i
    lib.wavefront_fixed_launch.argtypes = [p] * 17 + [i, i, i, i, p]


LIBRARY = CudaLibrary("wavefront_fixed.cu", _configure)


def active_rows(t: int, mh: int, mw: int):
    """MB rows with 0 <= t - 2*my < mw on diagonal t (empty: hi < lo)."""
    lo = max(0, (t - mw + 2) // 2)
    hi = min(mh - 1, t // 2)
    return lo, hi


def _tiles(plane, size):
    """(B, H, W) → (B, mh, mw, size, size) macroblock tiles (a view)."""
    B, H, W = plane.shape
    return plane.reshape(B, H // size, size, W // size, size).permute(
        0, 1, 3, 2, 4)


def _plane(tiles):
    """(B, mh, mw, s, s) tiles → (B, mh*s, mw*s) plane."""
    B, mh, mw, s, _ = tiles.shape
    return tiles.permute(0, 1, 3, 2, 4).reshape(B, mh * s, mw * s)


def _quant_rows(cf, iq, q, k_dc, k_ac, bias_dc, bias_ac, first_ac=False,
                refine=None):
    """Per-MB quantize + dequantize of (M, ..., 4, 4) raster blocks with
    the MB's (M, 6) quantizer rows; returns (levels, dequantized).
    ``refine(levels, cf)``, if given, refines the levels before the
    dequantization (``Trellis.refine``)."""
    extra = (None,) * (cf.dim() - 3)
    iq_dc, iq_ac = iq[(slice(None), k_dc) + extra], iq[(slice(None), k_ac) + extra]
    lv = quantize(cf, iq_dc, bias_dc, iq_ac, bias_ac, first_ac=first_ac)
    if refine is not None:
        lv = refine(lv, cf)
    deq = dequantize(lv, q[(slice(None), k_dc) + extra],
                     q[(slice(None), k_ac) + extra])
    return lv, deq


class Trellis:
    """The trellis pass of ``wavefront_plain`` (method 6): every block's
    levels refined by ``trellis_refine`` right after its quantization,
    with ``rate`` {token type: its per-position (p0, p1, val) tables} and
    ``lams`` (B, 4) int32 per-segment lambdas."""

    def __init__(self, rate, lams):
        self.rate, self.lams = rate, lams

    def refine(self, type: int, first: int, lam, dc_q, ac_q):
        """A ``_quant_rows`` refine of (M, ..., 16) levels of M MBs with
        their (M,) lambdas and steps."""
        tabs = self.rate[type]

        def run(lv, cf):
            M = lv.shape[0]
            n = lv[..., 0].numel() // max(M, 1)

            def rep(t):
                return t[:, None].expand(M, n).reshape(-1)

            return trellis_refine(
                lv.reshape(-1, 16), cf.reshape(-1, 16), *tabs, first=first,
                ctx0=1, dc_q=rep(dc_q), ac_q=rep(ac_q),
                lam=rep(lam)).reshape(lv.shape)

        return run


class GivenModes:
    """The decisions of ``wavefront_plain`` read from its inputs: dense
    (B, mh, mw) int32 ymode/uvmode/is_i4 and (B, mh, mw, 16) imodes.

    A decider answers three questions for the M MBs ``mb`` = (bb, my,
    mx) of a diagonal: ``ymode`` from the source and the 4 whole-block
    predictions; ``i4``, once the i16 code is known, (adopt (M,) bool,
    the 16 B-modes (M, 16) to code) or None for no i4 chain at all;
    ``uvmode`` from the chroma source and predictions.
    """

    def __init__(self, ymode, uvmode, is_i4, imodes):
        self.modes = (ymode, uvmode, is_i4, imodes)

    def ymode(self, mb, src, pred4):
        return self.modes[0][mb].long()

    def i4(self, mb, sg, src, ctx, q, iq, y_lv, y2_lv, recon16):
        return self.modes[2][mb] != 0, self.modes[3][mb].long()

    def uvmode(self, mb, csrc, cpred4):
        return self.modes[1][mb].long()


def wavefront_fixed_plain(y, u, v, seg, qsteps, ymode, uvmode, is_i4, imodes,
                          *, use_derr: bool, want_recon: bool):
    """Per-diagonal torch loop (any device); same contract as the kernel."""
    out = wavefront_plain(y, u, v, seg, qsteps,
                          GivenModes(ymode, uvmode, is_i4, imodes),
                          use_derr=use_derr, want_recon=want_recon)
    for k in ("ymode", "uvmode", "is_i4", "imodes"):
        del out[k]
    return out


def wavefront_plain(y, u, v, seg, qsteps, decide, *, use_derr: bool,
                    want_recon: bool, trellis=None, above=None,
                    want_edge: bool = False):
    """The closed-loop MB encode as a per-diagonal torch loop (any device),
    each MB's modes picked by ``decide`` (``GivenModes``, or the in-loop
    search of ops/kernels/wavefront_search.py), every block's levels
    trellis-refined when ``trellis`` (a ``Trellis``) is given.

    Returns the kernel's outputs plus the modes coded: int32 ymode,
    uvmode, is_i4 (B, mh, mw) and imodes (B, mh, mw, 16), where an i16
    MB's imodes repeat its ymode.

    A stripe of MB rows below another stripe of the frame passes
    ``above`` = (hy (B, W), hu, hv (B, W/2) uint8, the stripe above's last
    recon rows; hdt (B, mw, 4) int16, its last MB row's UV DC carries
    [ch][k]): MB row 0 then has a row above and reads it from them.  They
    sit in a one-row apron above the recon and carry tensors.
    ``want_edge`` adds out["edge"], the same four of this stripe's last
    row, for the stripe below.
    """
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    dev = y.device
    qs = qsteps.to(I32)
    iqs = (1 << 17) // qs.clamp_min(1)
    ys, us, vs = (_tiles(p.to(I32), s) for p, s in ((y, 16), (u, 8), (v, 8)))
    o = 0 if above is None else 1        # the apron's rows
    Ry = torch.zeros((B, mh + o, mw, 16, 16), dtype=I32, device=dev)
    Rc = torch.zeros((2, B, mh + o, mw, 8, 8), dtype=I32, device=dev)
    # UV DC error-diffusion carries [ch][pair], stored as int16 values
    Dt = torch.zeros((B, mh + o, mw, 2, 2), dtype=I32, device=dev)
    Dl = torch.zeros((B, mh, mw, 2, 2), dtype=I32, device=dev)
    if above is not None:
        hy, hu, hv, hdt = above
        Ry[:, 0, :, 15] = hy.to(I32).reshape(B, mw, 16)
        Rc[0, :, 0, :, 7] = hu.to(I32).reshape(B, mw, 8)
        Rc[1, :, 0, :, 7] = hv.to(I32).reshape(B, mw, 8)
        Dt[:, 0] = hdt.to(I32).reshape(B, mw, 2, 2)
    out_y = torch.zeros((B, mh, mw, 16, 16), dtype=I32, device=dev)
    out_y2 = torch.zeros((B, mh, mw, 16), dtype=I32, device=dev)
    out_uv = torch.zeros((B, mh, mw, 8, 16), dtype=I32, device=dev)
    out_modes = torch.zeros((B, mh, mw, 19), dtype=I32, device=dev)

    for t in range(num_diagonals(mw, mh)):
        lo, hi = active_rows(t, mh, mw)
        if hi < lo:
            continue
        R = hi - lo + 1
        bb = torch.arange(B, device=dev).repeat_interleave(R)
        my = torch.arange(lo, hi + 1, device=dev).repeat(B)
        mx = t - 2 * my
        mb = (bb, my, mx)
        M = bb.shape[0]
        lanes = torch.arange(M, device=dev)
        ht, hl = (my > 0) | (o > 0), mx > 0
        # rows of the apron-shifted recon and carry tensors
        myo, myu = my + o, (my - 1 + o).clamp_min(0)
        mxl = (mx - 1).clamp_min(0)
        mxr = (mx + 1).clamp_max(mw - 1)
        ht1, hl1 = ht[:, None], hl[:, None]
        sg = seg[mb].long()
        q = qs[bb, sg]                                  # (M, 6)
        iq = iqs[bb, sg]
        refine = {}
        if trellis is not None:
            lam = trellis.lams[bb, sg]
            refine = {"y1": trellis.refine(0, 1, lam, q[:, 0], q[:, 1]),
                      "y2": trellis.refine(1, 0, lam, q[:, 2], q[:, 3]),
                      "i4": trellis.refine(3, 0, lam, q[:, 0], q[:, 1]),
                      "uv": trellis.refine(2, 0, lam, q[:, 4], q[:, 5])}

        # ---- luma context (edge rules) ----
        top16 = torch.where(ht1, Ry[bb, myu, mx, 15, :], 127)
        tr4 = torch.where((mx == mw - 1)[:, None], top16[:, 15:16],
                          Ry[bb, myu, mxr, 15, 0:4])
        tr4 = torch.where(ht1, tr4, 127)
        left16 = torch.where(hl1, Ry[bb, myo, mxl][..., :, 15], 129)
        tl = torch.where(ht, torch.where(hl, Ry[bb, myu, mxl, 15, 15], 129),
                         127)
        src = ys[mb]                                    # (M, 16, 16)

        # ---- i16 path ----
        pred4 = predict4_blocks(top16, left16, tl, ht, hl, 16)
        ymode = decide.ymode(mb, src, pred4)
        pred = pred4[ymode, lanes]
        blk = (src - pred).reshape(M, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
        coeffs = fdct4x4(blk)                           # (M, gy, gx, 4, 4)
        y2_lv, y2_deq = _quant_rows(fwht4x4(coeffs[..., 0, 0])[:, None], iq,
                                    q, 2, 3, BIAS["y2_dc"], BIAS["y2_ac"],
                                    refine=refine.get("y2"))
        y2_lv, y2_deq = y2_lv[:, 0], y2_deq[:, 0]
        y_lv, deq = _quant_rows(coeffs.reshape(M, 16, 4, 4), iq, q, 0, 1,
                                BIAS["y1_dc"], BIAS["y1_ac"], first_ac=True,
                                refine=refine.get("y1"))
        any_ac = (y2_lv[:, 1:] != 0).any(dim=-1)
        dc_only = ((y2_deq[:, 0, 0] + 3) >> 3)[:, None, None]
        rdcs = torch.where(any_ac[:, None, None], iwht4x4(y2_deq), dc_only)
        deq = deq.reshape(M, 4, 4, 4, 4).clone()
        deq[..., 0, 0] = rdcs
        pred_blk = pred.reshape(M, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
        recon16 = idct_add_clip(deq, pred_blk).permute(0, 1, 3, 2, 4).reshape(
            M, 16, 16)

        # ---- i4 path: the 16 sub-blocks' chain in raster order ----
        modes16 = ymode[:, None].expand(M, 16)
        recon_y = recon16
        pick = decide.i4(mb, sg, src, (top16, tr4, left16, tl), q, iq, y_lv,
                         y2_lv, recon16)
        adopt = torch.zeros(M, dtype=torch.bool, device=dev)
        if pick is not None:
            adopt, given4 = pick
            scr = torch.zeros((M, 17, 21), dtype=I32, device=dev)
            scr[:, 0, 0] = tl
            scr[:, 0, 1:17] = top16
            scr[:, 0, 17:21] = tr4
            scr[:, 1:17, 0] = left16
            yl4 = torch.zeros((M, 16, 16), dtype=I32, device=dev)
            for n in range(16):
                gy, gx = n >> 2, n & 3
                r, c = 4 * gy, 4 * gx
                tr = scr[:, 0, 17:21] if gx == 3 else scr[:, r, c + 5:c + 9]
                preds = _pred_luma4_all(scr[:, r, c], scr[:, r, c + 1:c + 5],
                                        tr, scr[:, r + 1:r + 5, c])
                pred1 = preds[lanes, given4[:, n]]
                cf = fdct4x4(src[:, r:r + 4, c:c + 4] - pred1)
                blv, dq = _quant_rows(cf[:, None], iq, q, 0, 1,
                                      BIAS["y1_dc"], BIAS["y1_ac"],
                                      refine=refine.get("i4"))
                yl4[:, n] = blv[:, 0]
                scr[:, r + 1:r + 5, c + 1:c + 5] = idct_add_clip(dq[:, 0],
                                                                 pred1)
            y_lv = torch.where(adopt[:, None, None], yl4, y_lv)
            y2_lv = torch.where(adopt[:, None], 0, y2_lv)
            recon_y = torch.where(adopt[:, None, None], scr[:, 1:17, 1:17],
                                  recon16)
            modes16 = torch.where(adopt[:, None], given4, modes16)

        # ---- chroma (U and V on a leading channel axis) ----
        ctop = torch.where(ht1[None], Rc[:, bb, myu, mx][..., 7, :], 127)
        cleft = torch.where(hl1[None], Rc[:, bb, myo, mxl][..., :, 7], 129)
        ctl = torch.where(ht[None], torch.where(
            hl[None], Rc[:, bb, myu, mxl][..., 7, 7], 129), 127)
        cpred4 = predict4_blocks(ctop, cleft, ctl, ht[None], hl[None], 8)
        csrc = torch.stack([us[mb], vs[mb]])                     # (2, M, 8, 8)
        uvmode = decide.uvmode(mb, csrc, cpred4)
        cpred = cpred4[uvmode, :, lanes].permute(1, 0, 2, 3)
        cblk = (csrc - cpred).reshape(2, M, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5)
        ccf = fdct4x4(cblk)                                      # (2,M,2,2,4,4)
        if use_derr:
            dtop = torch.where(ht[:, None, None], Dt[bb, myu, mx], 0)
            dleft = torch.where(hl[:, None, None], Dl[bb, my, mxl], 0)
            iqdc, qdc = iq[:, 4], q[:, 4]

            def qsingle(vv):
                av = vv.abs()
                lvl = torch.clamp_max((av * iqdc + BIAS["uv_dc"]) >> 17, 2047)
                err = av - lvl * qdc
                return torch.where(vv < 0, -err, err) >> 1

            ccf = ccf.clone()
            nl, nt = [], []
            for ch in range(2):
                dc = ccf[ch, :, :, :, 0, 0]                      # (M, 2, 2)
                dt0, dt1 = dtop[:, ch, 0], dtop[:, ch, 1]
                dl0, dl1 = dleft[:, ch, 0], dleft[:, ch, 1]
                c00 = dc[:, 0, 0] + ((7 * dt0 + 8 * dl0) >> 3)
                e0 = qsingle(c00)
                c01 = dc[:, 0, 1] + ((7 * dt1 + 8 * e0) >> 3)
                e1 = qsingle(c01)
                c10 = dc[:, 1, 0] + ((7 * e0 + 8 * dl1) >> 3)
                e2 = qsingle(c10)
                c11 = dc[:, 1, 1] + ((7 * e1 + 8 * e2) >> 3)
                e3 = qsingle(c11)
                ccf[ch, :, :, :, 0, 0] = torch.stack(
                    [torch.stack([c00, c01], -1), torch.stack([c10, c11], -1)],
                    -2)
                lv1 = (3 * e3) >> 2
                nl.append(torch.stack([e1, lv1], -1))
                nt.append(torch.stack([e2, e3 - lv1], -1))
            as16 = lambda a: a.to(torch.int16).to(I32)  # noqa: E731
            Dl[bb, my, mx] = as16(torch.stack(nl, 1))
            Dt[bb, myo, mx] = as16(torch.stack(nt, 1))
        clv, cdq = _quant_rows(ccf.permute(1, 0, 2, 3, 4, 5).reshape(
            M, 8, 4, 4), iq, q, 4, 5, BIAS["uv_dc"], BIAS["uv_ac"],
            refine=refine.get("uv"))
        cpred_blk = cpred.reshape(2, M, 2, 4, 2, 4).permute(1, 0, 2, 4, 3, 5)
        crec = idct_add_clip(cdq.reshape(M, 2, 2, 2, 4, 4), cpred_blk)
        crec = crec.permute(1, 0, 2, 4, 3, 5).reshape(2, M, 8, 8)

        Ry[bb, myo, mx] = recon_y
        Rc[:, bb, myo, mx] = crec
        out_y[bb, my, mx] = y_lv
        out_y2[bb, my, mx] = y2_lv
        out_uv[bb, my, mx] = clv
        out_modes[bb, my, mx] = torch.cat(
            [torch.stack([ymode, uvmode, adopt.long()], 1), modes16], 1).to(I32)

    I16 = torch.int16
    out = {"y_levels": out_y.to(I16), "y2_levels": out_y2.to(I16),
           "uv_levels": out_uv.to(I16), "ymode": out_modes[..., 0],
           "uvmode": out_modes[..., 1], "is_i4": out_modes[..., 2],
           "imodes": out_modes[..., 3:]}
    U8 = torch.uint8
    if want_recon:
        out["recon_y"] = _plane(Ry[:, o:]).to(U8)
        out["recon_u"] = _plane(Rc[0, :, o:]).to(U8)
        out["recon_v"] = _plane(Rc[1, :, o:]).to(U8)
    if want_edge:
        out["edge"] = (Ry[:, -1, :, 15].reshape(B, W).to(U8),
                       Rc[0, :, -1, :, 7].reshape(B, W // 2).to(U8),
                       Rc[1, :, -1, :, 7].reshape(B, W // 2).to(U8),
                       Dt[:, -1].reshape(B, mw, 4).to(I16))
    return out


def wavefront_fixed(y, u, v, seg, qsteps, ymode, uvmode, is_i4, imodes,
                    *, use_derr: bool, want_recon: bool):
    """Kernel on CUDA tensors, plain version on CPU tensors.

    ``wavefront_fixed.launches`` counts kernel launches (one per call on
    CUDA: the whole wavefront is one persistent launch).
    """
    dev = y.device
    if dev.type == "cpu":
        return wavefront_fixed_plain(y, u, v, seg, qsteps, ymode, uvmode,
                                     is_i4, imodes, use_derr=use_derr,
                                     want_recon=want_recon)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_fixed: unsupported device {dev}")
    B, H, W = y.shape
    if H % 16 or W % 16 or H == 0 or W == 0:
        raise ValueError(f"wavefront_fixed: planes must be MB multiples, "
                         f"got {H}x{W}")
    mh, mw = H // 16, W // 16
    U8 = torch.uint8
    check_tensor("y", y, U8, (B, H, W), dev)
    check_tensor("u", u, U8, (B, H // 2, W // 2), dev)
    check_tensor("v", v, U8, (B, H // 2, W // 2), dev)
    check_tensor("qsteps", qsteps, I32, (B, 4, 6), dev)
    for name, tns in (("seg", seg), ("ymode", ymode), ("uvmode", uvmode),
                      ("is_i4", is_i4)):
        check_tensor(name, tns, I32, (B, mh, mw), dev)
    check_tensor("imodes", imodes, I32, (B, mh, mw, 16), dev)
    lib = LIBRARY.load()
    I16 = torch.int16
    ry = torch.empty((B, H, W), dtype=U8, device=dev)
    ru = torch.empty((B, H // 2, W // 2), dtype=U8, device=dev)
    rv = torch.empty_like(ru)
    dtop = torch.empty((B, mh, mw, 4), dtype=I16, device=dev)
    # per-row progress counters, then the row ticket (the kernel's sync)
    sync = torch.zeros(B * mh + 1, dtype=I32, device=dev)
    ylv = torch.empty((B, mh, mw, 16, 16), dtype=I16, device=dev)
    y2lv = torch.empty((B, mh, mw, 16), dtype=I16, device=dev)
    uvlv = torch.empty((B, mh, mw, 8, 16), dtype=I16, device=dev)
    err = lib.wavefront_fixed_launch(
        y.data_ptr(), u.data_ptr(), v.data_ptr(), seg.data_ptr(),
        qsteps.data_ptr(), ymode.data_ptr(), uvmode.data_ptr(),
        is_i4.data_ptr(), imodes.data_ptr(), ry.data_ptr(), ru.data_ptr(),
        rv.data_ptr(), dtop.data_ptr(), ylv.data_ptr(), y2lv.data_ptr(),
        uvlv.data_ptr(), sync.data_ptr(), B, mh, mw, int(bool(use_derr)),
        stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"wavefront_fixed kernel launch failed: CUDA error {err}")
    wavefront_fixed.launches += 1
    out = {"y_levels": ylv, "y2_levels": y2lv, "uv_levels": uvlv}
    if want_recon:
        out.update(recon_y=ry, recon_u=ru, recon_v=rv)
    return out


wavefront_fixed.launches = 0

__all__ = ["GivenModes", "LIBRARY", "Trellis", "active_rows",
           "wavefront_fixed",
           "wavefront_fixed_plain", "wavefront_plain"]
