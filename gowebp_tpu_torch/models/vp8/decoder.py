"""VP8 (WebP lossy) decoder, host half: headers, the symbol engines and
the host reconstruction.

The decode is split in two.  This module runs the sequential entropy
decode on the host: the frame header in Python, then the per-MB modes
and coefficient tokens in the native C++ layer (ctypes, GIL released).
It produces dense per-MB arrays: dequantized coefficients, modes and
loop-filter parameters.  By default everything pixel-shaped (iDCT, intra
prediction, the loop filter, upsampling and colour conversion) runs on
the device in ops/vp8_recon.py, ops/yuv.py and the yuv420_to_rgba kernel.
The incremental decoder (idec.py) parses MB by MB in Python instead
(``_parse_intra_mode``, ``_parse_residuals``), so that it can stop and
resume anywhere in a stream that has not all arrived; ``mb_symbols``
turns its parsed MBs into the native engine's arrays.  The bit
accounting (utils/bittrace.py) parses a whole frame the same way
(``_parse_frame_mbs``), counting the bits each syntax class consumes.
``recon_vp8_yuv_host`` and ``yuv_planes_to_rgba`` do the same work in the
native layer instead (the batch decode's ``recon_backend="host"``), with
the same pixels.

Written from RFC 6386.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from ...constants import VP8_SIGNATURE
from ...entropy.bool_coder import BoolDecoder
from ...entropy.native_loader import get_lib
from ...errors import BitstreamError, UnsupportedFeature
from .tables import (AC_QUANT, B_DC, B_HE, B_TM, B_VE, BANDS, BMODE_TREE,
                     CAT_PROBAS, COEFF_PROBAS, COEFF_UPDATE_PROBAS, DC_QUANT,
                     KF_BMODE_PROBAS, ZIGZAG)

# ---------------------------------------------------------------------------
# Headers
# ---------------------------------------------------------------------------


@dataclass
class SegmentHeader:
    use_segment: bool = False
    update_map: bool = False
    absolute_delta: bool = True
    quantizer: list = field(default_factory=lambda: [0] * 4)
    filter_strength: list = field(default_factory=lambda: [0] * 4)


@dataclass
class FilterHeader:
    simple: bool = False
    level: int = 0
    sharpness: int = 0
    use_lf_delta: bool = False
    ref_lf_delta: list = field(default_factory=lambda: [0] * 4)
    mode_lf_delta: list = field(default_factory=lambda: [0] * 4)


@dataclass
class QuantMatrix:
    y1_dc: int = 0
    y1_ac: int = 0
    y2_dc: int = 0
    y2_ac: int = 0
    uv_dc: int = 0
    uv_ac: int = 0
    uv_quant: int = 0   # unclamped uv AC index, for the dithering strength


@dataclass
class FrameState:
    width: int = 0
    height: int = 0
    mb_w: int = 0
    mb_h: int = 0
    segment_hdr: SegmentHeader = field(default_factory=SegmentHeader)
    filter_hdr: FilterHeader = field(default_factory=FilterHeader)
    filter_type: int = 0            # 0=none, 1=simple, 2=complex
    dqm: list = field(default_factory=list)        # QuantMatrix per segment
    segment_probs: list = field(default_factory=lambda: [255] * 3)
    coeff_probs: np.ndarray | None = None           # (4,8,3,11)
    use_skip_proba: bool = False
    skip_p: int = 0
    partition_bytes: list = field(default_factory=list)

    def quant_rows(self) -> np.ndarray:
        """(4, 6) int32 [y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac] rows."""
        return np.array([[m.y1_dc, m.y1_ac, m.y2_dc, m.y2_ac, m.uv_dc,
                          m.uv_ac] for m in self.dqm], np.int32)


def _clip(v, mx):
    return 0 if v < 0 else (mx if v > mx else v)


def parse_frame_header(payload: bytes) -> tuple[FrameState, BoolDecoder]:
    """Parse the uncompressed frame tag + first partition headers."""
    if len(payload) < 10:
        raise BitstreamError("VP8 payload too small")
    tag = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if tag & 1:
        raise UnsupportedFeature("not a key frame")
    show = (tag >> 4) & 1
    part0_len = tag >> 5
    if not show:
        raise UnsupportedFeature("non-displayable frame")
    if ((payload[3] << 16) | (payload[4] << 8) | payload[5]) != VP8_SIGNATURE:
        raise BitstreamError("bad VP8 start code")
    st = FrameState()
    st.width = (payload[6] | (payload[7] << 8)) & 0x3FFF
    st.height = (payload[8] | (payload[9] << 8)) & 0x3FFF
    if st.width == 0 or st.height == 0:
        raise BitstreamError("bad dimensions")
    st.mb_w = (st.width + 15) >> 4
    st.mb_h = (st.height + 15) >> 4

    body = payload[10:]
    if part0_len > len(body):
        raise BitstreamError("bad partition0 length")
    bd = BoolDecoder(body[:part0_len])

    bd.get_flag()  # color_space
    bd.get_flag()  # clamp_type

    # Segment header (RFC 9.3).
    sh = st.segment_hdr
    sh.use_segment = bool(bd.get_flag())
    if sh.use_segment:
        sh.update_map = bool(bd.get_flag())
        if bd.get_flag():  # update data
            sh.absolute_delta = bool(bd.get_flag())
            for s in range(4):
                sh.quantizer[s] = bd.get_signed_literal(7) if bd.get_flag() else 0
            for s in range(4):
                sh.filter_strength[s] = bd.get_signed_literal(6) if bd.get_flag() else 0
        if sh.update_map:
            for s in range(3):
                st.segment_probs[s] = bd.get_literal(8) if bd.get_flag() else 255

    # Filter header (RFC 9.4).
    fh = st.filter_hdr
    fh.simple = bool(bd.get_flag())
    fh.level = bd.get_literal(6)
    fh.sharpness = bd.get_literal(3)
    fh.use_lf_delta = bool(bd.get_flag())
    if fh.use_lf_delta:
        if bd.get_flag():
            for i in range(4):
                if bd.get_flag():
                    fh.ref_lf_delta[i] = bd.get_signed_literal(6)
            for i in range(4):
                if bd.get_flag():
                    fh.mode_lf_delta[i] = bd.get_signed_literal(6)
    st.filter_type = 0 if fh.level == 0 else (1 if fh.simple else 2)

    # Token partitions (RFC 9.5).
    rest = body[part0_len:]
    num_parts = 1 << bd.get_literal(2)
    sizes_bytes = 3 * (num_parts - 1)
    if len(rest) < sizes_bytes:
        raise BitstreamError("cannot read partition sizes")
    pos = sizes_bytes
    for p in range(num_parts - 1):
        psz = rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16)
        psz = min(psz, len(rest) - pos)
        st.partition_bytes.append(rest[pos : pos + psz])
        pos += psz
    st.partition_bytes.append(rest[pos:])

    # Quantizers (RFC 9.6).
    base_q0 = bd.get_literal(7)
    dqy1_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dqy2_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dqy2_ac = bd.get_signed_literal(4) if bd.get_flag() else 0
    dquv_dc = bd.get_signed_literal(4) if bd.get_flag() else 0
    dquv_ac = bd.get_signed_literal(4) if bd.get_flag() else 0
    st.dqm = []
    for s in range(4):
        if sh.use_segment:
            q = sh.quantizer[s] + (0 if sh.absolute_delta else base_q0)
        else:
            q = base_q0
        m = QuantMatrix()
        m.y1_dc = int(DC_QUANT[_clip(q + dqy1_dc, 127)])
        m.y1_ac = int(AC_QUANT[_clip(q, 127)])
        m.y2_dc = int(DC_QUANT[_clip(q + dqy2_dc, 127)]) * 2
        m.y2_ac = max(8, (int(AC_QUANT[_clip(q + dqy2_ac, 127)]) * 101581) >> 16)
        m.uv_dc = int(DC_QUANT[_clip(q + dquv_dc, 117)])
        m.uv_ac = int(AC_QUANT[_clip(q + dquv_ac, 127)])
        m.uv_quant = q + dquv_ac
        st.dqm.append(m)

    # Probability updates (RFC 9.8-9.11): ~1100 boolean decisions, parsed
    # natively so that the batch decoder's threads do not serialise on
    # the GIL here.
    st.coeff_probs = _parse_probs_native(st, bd)
    return st, bd


_UPDATE_PROBAS_U8 = np.ascontiguousarray(COEFF_UPDATE_PROBAS, np.uint8).reshape(-1)


def _parse_probs_native(st: FrameState, bd: BoolDecoder) -> np.ndarray:
    """Native coeff-proba block parse; syncs the bool decoder state and
    sets ``st``'s skip probability.  Returns the (4, 8, 3, 11) table."""
    lib = get_lib()
    pflat = np.ascontiguousarray(COEFF_PROBAS, np.uint8).reshape(-1).copy()
    state = np.array([bd.pos, bd.value, bd.range, bd.bit_count], np.uint64)
    data = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
    dview = np.frombuffer(data, np.uint8)   # zero-copy view
    rc = lib.wtpu_vp8_parse_probs(
        dview.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _UPDATE_PROBAS_U8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pflat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise BitstreamError("truncated frame header")
    bd.pos, bd.value, bd.range, bd.bit_count = (
        int(state[0]), int(state[1]), int(state[2]), int(state[3]))
    st.use_skip_proba = bool(rc >> 8)
    st.skip_p = rc & 0xFF
    return pflat.reshape(COEFF_PROBAS.shape)


# ---------------------------------------------------------------------------
# Loop-filter strengths
# ---------------------------------------------------------------------------


def _precompute_filter_info(st: FrameState):
    """Per (segment, is_i4): (limit, ilevel, hev_thresh) or None."""
    fh = st.filter_hdr
    info = [[None, None] for _ in range(4)]
    if st.filter_type == 0:
        return info
    for s in range(4):
        if st.segment_hdr.use_segment:
            base = st.segment_hdr.filter_strength[s]
            if not st.segment_hdr.absolute_delta:
                base += fh.level
        else:
            base = fh.level
        for i4 in range(2):
            level = base
            if fh.use_lf_delta:
                level += fh.ref_lf_delta[0]
                if i4:
                    level += fh.mode_lf_delta[0]
            level = _clip(level, 63)
            if level > 0:
                ilevel = level
                if fh.sharpness > 0:
                    ilevel = ilevel >> 2 if fh.sharpness > 4 else ilevel >> 1
                    ilevel = min(ilevel, 9 - fh.sharpness)
                ilevel = max(1, ilevel)
                hev_t = 2 if level >= 40 else (1 if level >= 15 else 0)
                info[s][i4] = (2 * level + ilevel, ilevel, hev_t)
            else:
                info[s][i4] = None
    return info


def vp8_filter_params(st: FrameState, modes: np.ndarray) -> np.ndarray:
    """Per-MB loop-filter parameters for the device filter.

    Returns int32 (mb_h, mb_w, 4): [limit, ilevel, hev_thresh, inner];
    limit < 0 disables filtering for the MB.
    """
    finfo = _precompute_filter_info(st)
    n = st.mb_w * st.mb_h
    out = np.full((n, 4), -1, np.int32)
    if st.filter_type == 0:
        return out.reshape(st.mb_h, st.mb_w, 4)
    is_i4 = modes[:, 0].astype(np.int64)
    seg = modes[:, 2].astype(np.int64)
    skip = modes[:, 3].astype(np.int64)
    for s in range(4):
        for i4 in range(2):
            fi = finfo[s][i4]
            if fi is None:
                continue
            sel = (seg == s) & (is_i4 == i4)
            out[sel, 0] = fi[0]
            out[sel, 1] = fi[1]
            out[sel, 2] = fi[2]
    # inner edges filter when the MB is i4 or has coefficients
    inner = ((is_i4 != 0) | (skip == 0)).astype(np.int32)
    out[:, 3] = inner
    return out.reshape(st.mb_h, st.mb_w, 4)


# ---------------------------------------------------------------------------
# Per-MB Python parse (the incremental decoder)
# ---------------------------------------------------------------------------


def _iwht4x4(coeffs: np.ndarray) -> np.ndarray:
    """Inverse Walsh-Hadamard of the Y2 block → the 16 luma DC values."""
    c = coeffs.astype(np.int64).reshape(4, 4)
    a0 = c[0] + c[3]
    a1 = c[1] + c[2]
    a2 = c[1] - c[2]
    a3 = c[0] - c[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2]).T
    dc = t[0] + 3
    a0 = dc + t[3]
    a1 = t[1] + t[2]
    a2 = t[1] - t[2]
    a3 = dc - t[3]
    out = np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
                    (a3 - a2) >> 3]).T
    return out.reshape(16)


def _parse_intra_mode(bd: BoolDecoder, st: FrameState, top4: np.ndarray,
                      left4: np.ndarray):
    """One MB's segment/skip/modes. Returns (segment, skip, is_i4, imodes, uv)."""
    segment = 0
    if st.segment_hdr.update_map:
        if not bd.get_bit(st.segment_probs[0]):
            segment = bd.get_bit(st.segment_probs[1])
        else:
            segment = 2 + bd.get_bit(st.segment_probs[2])
    skip = bd.get_bit(st.skip_p) if st.use_skip_proba else 0

    imodes = np.zeros(16, np.int32)
    is_i4 = not bd.get_bit(145)
    if not is_i4:
        # Hardcoded 16x16 mode tree (libwebp enum DC/TM/VE/HE).
        if bd.get_bit(156):
            ymode = B_TM if bd.get_bit(128) else B_HE
        else:
            ymode = B_VE if bd.get_bit(163) else B_DC
        imodes[:] = ymode
        top4[:] = ymode
        left4[:] = ymode
    else:
        for y in range(4):
            ymode = left4[y]
            for x in range(4):
                prob = KF_BMODE_PROBAS[top4[x]][ymode]
                i = BMODE_TREE[bd.get_bit(int(prob[0]))]
                while i > 0:
                    i = BMODE_TREE[2 * i + bd.get_bit(int(prob[i]))]
                ymode = -i
                top4[x] = ymode
                imodes[4 * y + x] = ymode
            left4[y] = ymode

    # UV mode tree.
    if not bd.get_bit(142):
        uvmode = B_DC
    elif not bd.get_bit(114):
        uvmode = B_VE
    elif bd.get_bit(183):
        uvmode = B_TM
    else:
        uvmode = B_HE
    return segment, skip, is_i4, imodes, uvmode


def _get_large_value(bd: BoolDecoder, p) -> int:
    if not bd.get_bit(int(p[3])):
        if not bd.get_bit(int(p[4])):
            return 2
        return 3 + bd.get_bit(int(p[5]))
    if not bd.get_bit(int(p[6])):
        if not bd.get_bit(int(p[7])):
            return 5 + bd.get_bit(159)
        return 7 + 2 * bd.get_bit(165) + bd.get_bit(145)
    bit1 = bd.get_bit(int(p[8]))
    bit0 = bd.get_bit(int(p[9 + bit1]))
    cat = 2 * bit1 + bit0
    v = 0
    for tab_p in CAT_PROBAS[cat]:
        v += v + bd.get_bit(tab_p)
    return v + 3 + (8 << cat)


def _get_coeffs(bd: BoolDecoder, probs_t, ctx: int, dq: tuple, first: int,
                out: np.ndarray) -> int:
    """Token-decode one 4x4 block; returns last-nonzero position + 1."""
    p = probs_t[BANDS[first]][ctx]
    n = first
    while n < 16:
        if not bd.get_bit(int(p[0])):
            return n
        while not bd.get_bit(int(p[1])):
            n += 1
            if n == 16:
                return 16
            p = probs_t[BANDS[n]][0]
        if not bd.get_bit(int(p[2])):
            v = 1
            next_ctx = 1
        else:
            v = _get_large_value(bd, p)
            next_ctx = 2
        out[ZIGZAG[n]] = bd.get_signed(v) * dq[n > 0]
        p = probs_t[BANDS[n + 1]][next_ctx]
        n += 1
    return 16


def _nz_code_bits(nz_coeffs: int, nz: int, dc_nz: int) -> int:
    nz_coeffs <<= 2
    nz_coeffs |= 3 if nz > 3 else (2 if nz > 1 else dc_nz)
    return nz_coeffs


@dataclass
class MBData:
    segment: int = 0
    skip: int = 0
    is_i4: bool = False
    imodes: np.ndarray | None = None
    uvmode: int = 0
    coeffs: np.ndarray | None = None     # (25, 16) int32, dequantized
    non_zero_y: int = 0
    non_zero_uv: int = 0
    dither: int = 0                      # 1 = flat chroma, dither-eligible


def _parse_residuals(bd: BoolDecoder, st: FrameState, mb: MBData,
                     ctx_mb, ctx_left) -> bool:
    """Decode all coefficients of one MB; updates nz contexts.

    ctx_mb/ctx_left are 2-element lists [nz, nz_dc] for above/left context.
    Returns True if the whole MB is empty (skippable).
    """
    probs = st.coeff_probs
    q = st.dqm[mb.segment]
    coeffs = np.zeros((25, 16), np.int32)
    first = 0
    if not mb.is_i4:
        dc = np.zeros(16, np.int32)
        ctx = ctx_mb[1] + ctx_left[1]
        nz = _get_coeffs(bd, probs[1], ctx, (q.y2_dc, q.y2_ac), 0, dc)
        ctx_mb[1] = ctx_left[1] = int(nz > 0)
        if nz > 1:
            coeffs[24] = dc
            dcs = _iwht4x4(dc)
        else:
            dc0 = (int(dc[0]) + 3) >> 3
            dcs = np.full(16, dc0, np.int32)
        for i in range(16):
            coeffs[i, 0] = dcs[i]
        first = 1
        ac_probs = probs[0]
    else:
        ac_probs = probs[3]

    non_zero_y = 0
    tnz = ctx_mb[0] & 0x0F
    lnz = ctx_left[0] & 0x0F
    for y in range(4):
        l = lnz & 1
        nz_coeffs = 0
        for x in range(4):
            ctx = l + (tnz & 1)
            blk = coeffs[4 * y + x]
            nz = _get_coeffs(bd, ac_probs, ctx, (q.y1_dc, q.y1_ac), first, blk)
            l = int(nz > first)
            tnz = (tnz >> 1) | (l << 7)
            nz_coeffs = _nz_code_bits(nz_coeffs, nz, int(blk[0] != 0))
        tnz >>= 4
        lnz = (lnz >> 1) | (l << 7)
        non_zero_y = (non_zero_y << 8) | nz_coeffs
    out_t_nz = tnz
    out_l_nz = lnz >> 4

    non_zero_uv = 0
    for ch in range(0, 4, 2):
        nz_coeffs = 0
        tnz = (ctx_mb[0] >> (4 + ch)) & 0xFF
        lnz = (ctx_left[0] >> (4 + ch)) & 0xFF
        for y in range(2):
            l = lnz & 1
            for x in range(2):
                ctx = l + (tnz & 1)
                blk = coeffs[16 + 2 * ch + 2 * y + x]
                nz = _get_coeffs(bd, probs[2], ctx, (q.uv_dc, q.uv_ac), 0, blk)
                l = int(nz > 0)
                tnz = (tnz >> 1) | (l << 3)
                nz_coeffs = _nz_code_bits(nz_coeffs, nz, int(blk[0] != 0))
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        non_zero_uv |= nz_coeffs << (4 * ch)
        out_t_nz |= ((tnz << 4) << ch) & 0xFFFFFFFF
        out_l_nz |= (lnz & 0xF0) << ch
    ctx_mb[0] = out_t_nz
    ctx_left[0] = out_l_nz

    mb.coeffs = coeffs
    mb.non_zero_y = non_zero_y
    mb.non_zero_uv = non_zero_uv
    # Dither only flat-chroma MBs: no uv block with coeffs beyond the
    # first (mask 0xAAAA = code >= 2 bits).
    mb.dither = 0 if (non_zero_uv & 0xAAAA) else 1
    return (non_zero_y | non_zero_uv) == 0


def mb_symbols(mbs) -> tuple[np.ndarray, np.ndarray]:
    """Parsed MBs (raster order) → the native engine's arrays: int16
    (N, 24, 16) dequantized raster coefficients (i16 luma DCs already
    the inverse WHT's) and uint8 (N, 21) modes [is_i4, uvmode, segment,
    skip, dither, imodes x16], as :func:`decode_vp8_symbols` gives them."""
    n = len(mbs)
    coeffs = np.zeros((n, 24, 16), np.int16)
    modes = np.zeros((n, 21), np.uint8)
    for i, mb in enumerate(mbs):
        coeffs[i] = mb.coeffs[:24]
        modes[i, :5] = (int(mb.is_i4), mb.uvmode, mb.segment, mb.skip,
                        mb.dither)
        modes[i, 5:] = mb.imodes
    return coeffs, modes


def _bitpos(bd: BoolDecoder) -> int:
    """A monotone count of the bits a boolean decoder has consumed."""
    return 8 * bd.pos + bd.bit_count


def _parse_frame_mbs(st: FrameState, bd: BoolDecoder,
                     trace: dict | None = None) -> list:
    """The whole frame's modes (partition 0) and tokens, parsed in Python
    with ``_parse_intra_mode`` and ``_parse_residuals``: the mb_h x mb_w
    grid of MBData.

    With ``trace`` (a dict holding "intra_modes" and a "residuals" list,
    one entry a token partition), the bits each MB row consumes are added
    to it: its modes to "intra_modes", its tokens to its partition's
    entry (the bit accounting of utils/bittrace.py).
    """
    mb_w, mb_h = st.mb_w, st.mb_h
    parts = [BoolDecoder(pb) for pb in st.partition_bytes]
    intra_t = np.full(4 * mb_w, B_DC, np.int32)
    mbs = [[MBData() for _ in range(mb_w)] for _ in range(mb_h)]
    ctx_above = [[0, 0] for _ in range(mb_w)]   # [nz, nz_dc] per column
    for mb_y in range(mb_h):
        intra_l = np.full(4, B_DC, np.int32)
        ctx_left = [0, 0]
        part_idx = mb_y & (len(parts) - 1)
        token_bd = parts[part_idx]
        t0, p0 = _bitpos(bd), _bitpos(token_bd)
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            (mb.segment, mb.skip, mb.is_i4, mb.imodes, mb.uvmode) = \
                _parse_intra_mode(bd, st, intra_t[4 * mb_x : 4 * mb_x + 4],
                                  intra_l)
        if trace is not None:
            trace["intra_modes"] += _bitpos(bd) - t0
        for mb_x in range(mb_w):
            mb = mbs[mb_y][mb_x]
            skip = mb.skip if st.use_skip_proba else 0
            if not skip:
                mb.skip = int(_parse_residuals(token_bd, st, mb,
                                               ctx_above[mb_x], ctx_left))
            else:
                ctx_above[mb_x][0] = 0
                ctx_left[0] = 0
                if not mb.is_i4:
                    ctx_above[mb_x][1] = 0
                    ctx_left[1] = 0
                mb.coeffs = np.zeros((25, 16), np.int32)
                mb.non_zero_y = 0
                mb.non_zero_uv = 0
                mb.skip = 1
            if token_bd.exhausted():
                raise BitstreamError("truncated token partition")
        if trace is not None:
            trace["residuals"][part_idx] += _bitpos(token_bd) - p0
    return mbs


# ---------------------------------------------------------------------------
# Symbol engines
# ---------------------------------------------------------------------------


def _partition_bounds(st: FrameState) -> tuple[bytes, np.ndarray]:
    """All token partitions back to back, and their (P + 1) byte offsets."""
    bounds = np.zeros(len(st.partition_bytes) + 1, np.uint64)
    bounds[1:] = np.cumsum([len(pb) for pb in st.partition_bytes])
    return b"".join(st.partition_bytes), bounds


def decode_vp8_symbols(payload: bytes, bypass_filtering: bool = False,
                       filter_level_override: int | None = None):
    """Host entropy phase of one image, single-stream engine.

    Returns ``(st, coeffs, modes)``: ``coeffs`` int16 (mb_h*mb_w, 24, 16)
    dequantized coefficients in raster order within each block (luma DCs
    already inverse-WHT'd for i16 MBs), ``modes`` uint8 (mb_h*mb_w, 21):
    [is_i4, uvmode, segment, skip, dither, imodes x16].
    ``bypass_filtering`` turns the loop filter off (``st.filter_type`` 0);
    ``filter_level_override`` replaces the header's filter level (the
    encoder's filter-level trials; 0 turns the filter off).
    """
    st, bd = parse_frame_header(payload)
    if filter_level_override is not None:
        st.filter_hdr.level = filter_level_override
        st.filter_type = 0 if filter_level_override == 0 else (
            1 if st.filter_hdr.simple else 2
        )
    if bypass_filtering:
        st.filter_type = 0
    n = st.mb_w * st.mb_h
    coeffs = np.zeros((n, 24, 16), np.int16)
    modes = np.zeros((n, 21), np.uint8)
    _decode_vp8_symbols_native(st, bd, coeffs, modes)
    return st, coeffs, modes


def _decode_vp8_symbols_native(st: FrameState, bd: BoolDecoder,
                               coeffs: np.ndarray, modes: np.ndarray) -> None:
    """C++ single-stream entropy decode into the provided arrays."""
    lib = get_lib()
    parts, offsets = _partition_bounds(st)
    seg_probs = np.array(st.segment_probs, np.uint8)
    probs = np.ascontiguousarray(st.coeff_probs, np.uint8)
    quants = st.quant_rows()
    p0 = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
    p0_buf = (ctypes.c_uint8 * len(p0)).from_buffer_copy(p0) if p0 else None
    parts_buf = (ctypes.c_uint8 * max(1, len(parts))).from_buffer_copy(
        parts if parts else b"\x00"
    )
    rc = lib.wtpu_vp8_decode_symbols(
        p0_buf, len(p0), bd.pos, bd.value, bd.range, bd.bit_count,
        parts_buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(st.partition_bytes),
        st.mb_w, st.mb_h,
        int(st.segment_hdr.update_map),
        seg_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(st.use_skip_proba), st.skip_p,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        quants.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise BitstreamError(f"native vp8 symbol decode failed (code {rc})")


def symbol_engine() -> str:
    """"vector" when the interleaved batch engine was built with its
    AVX-512 step (then decode_vp8_symbols_batch uses it), else
    "single-stream"."""
    return "vector" if get_lib().wtpu_vp8_batch_is_vectorized() else \
        "single-stream"


def decode_vp8_symbols_batch(payloads: list):
    """Entropy phase of many images; per-image output as
    :func:`decode_vp8_symbols`.

    Where the native layer was built with AVX-512, all images' token
    partitions are decoded as interleaved bitstreams in ONE native call
    (entropy/native/vp8_dec_batch.cpp): the boolean decoder is a serial
    dependency chain, so stepping many independent chains in vector
    lanes overlaps them.  Elsewhere that engine's scalar round-robin is
    slower than the single-stream decoder, which then runs per image.
    Both give identical arrays.
    """
    lib = get_lib()
    if not lib.wtpu_vp8_batch_is_vectorized():
        return [decode_vp8_symbols(p) for p in payloads]

    n = len(payloads)
    sts = []
    p0s, poss, vals, rngs, bcs = [], [], [], [], []
    parts_list, bounds_list, nparts = [], [], []
    dims, flags, segps, probs_l, quants_l = [], [], [], [], []
    for payload in payloads:
        st, bd = parse_frame_header(payload)
        sts.append(st)
        p0 = bd.data if isinstance(bd.data, bytes) else bytes(bd.data)
        p0s.append(np.frombuffer(p0, np.uint8))
        poss.append(bd.pos)
        vals.append(bd.value)
        rngs.append(bd.range)
        bcs.append(bd.bit_count)
        parts, bounds = _partition_bounds(st)
        parts_list.append(np.frombuffer(parts, np.uint8)
                          if parts else np.zeros(1, np.uint8))
        bounds_list.append(bounds)
        nparts.append(len(st.partition_bytes))
        dims.append((st.mb_w, st.mb_h))
        flags.append((int(st.segment_hdr.update_map),
                      int(st.use_skip_proba), st.skip_p))
        segps.append(np.array(st.segment_probs, np.uint8))
        probs_l.append(np.ascontiguousarray(st.coeff_probs,
                                            np.uint8).reshape(-1))
        quants_l.append(st.quant_rows().reshape(-1))

    def flat(arrs, dtype):
        off = np.zeros(len(arrs) + 1, np.uint64)
        off[1:] = np.cumsum([a.size for a in arrs])
        return np.ascontiguousarray(np.concatenate(arrs).astype(dtype)), off

    p0_all, p0_off = flat(p0s, np.uint8)
    parts_all, parts_off = flat(parts_list, np.uint8)
    bounds_all = np.concatenate(bounds_list).astype(np.uint64)
    bounds_off = np.zeros(n, np.int32)
    bounds_off[1:] = np.cumsum([b.size for b in bounds_list[:-1]])
    totals = np.array([w * h for w, h in dims], np.int64)
    coeffs_off = np.zeros(n + 1, np.uint64)
    coeffs_off[1:] = np.cumsum(totals * 24 * 16)
    modes_off = np.zeros(n + 1, np.uint64)
    modes_off[1:] = np.cumsum(totals * 21)
    coeffs_all = np.empty(int(coeffs_off[-1]), np.int16)
    modes_all = np.empty(int(modes_off[-1]), np.uint8)
    rc = np.zeros(n, np.int32)

    def cp(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    u8, i16, i32, u32, u64 = (ctypes.c_uint8, ctypes.c_int16, ctypes.c_int32,
                              ctypes.c_uint32, ctypes.c_uint64)
    nfail = lib.wtpu_vp8_decode_symbols_batch(
        n, cp(p0_all, u8), cp(p0_off, u64),
        cp(np.array(poss, np.uint64), u64),
        cp(np.array(vals, np.uint32), u32),
        cp(np.array(rngs, np.uint32), u32),
        cp(np.array(bcs, np.uint32), u32),
        cp(parts_all, u8), cp(parts_off, u64),
        cp(bounds_all, u64), cp(bounds_off, i32),
        cp(np.array(nparts, np.int32), i32),
        cp(np.array(dims, np.int32).reshape(-1), i32),
        cp(np.array(flags, np.int32).reshape(-1), i32),
        cp(np.concatenate(segps), u8),
        cp(np.concatenate(probs_l), u8),
        cp(np.concatenate(quants_l).astype(np.int32), i32),
        cp(coeffs_all, i16), cp(coeffs_off, u64),
        cp(modes_all, u8), cp(modes_off, u64),
        cp(rc, i32),
    )
    if nfail:
        bad = [i for i in range(n) if rc[i] != 0]
        raise BitstreamError(
            f"native batch vp8 symbol decode failed for images {bad}")
    out = []
    for i, st in enumerate(sts):
        t = int(totals[i])
        coeffs = coeffs_all[int(coeffs_off[i]):int(coeffs_off[i + 1])]
        modes = modes_all[int(modes_off[i]):int(modes_off[i + 1])]
        out.append((st, coeffs.reshape(t, 24, 16), modes.reshape(t, 21)))
    return out


# ---------------------------------------------------------------------------
# Host reconstruction
# ---------------------------------------------------------------------------


def recon_vp8_yuv_host(st: FrameState, coeffs: np.ndarray,
                       modes: np.ndarray):
    """Native reconstruction and loop filter from the symbol engines'
    arrays → the cropped (Y, U, V) uint8 planes, on the host."""
    mb_w, mb_h = st.mb_w, st.mb_h
    finfo = np.full((4, 2, 3), -1, np.int32)
    for s, row in enumerate(_precompute_filter_info(st)):
        for i4, fi in enumerate(row):
            if fi is not None:
                finfo[s, i4] = fi
    Y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    U = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    V = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    cf = np.ascontiguousarray(coeffs.reshape(-1), np.int16)
    md = np.ascontiguousarray(modes.reshape(-1), np.uint8)

    def p(arr, t):
        return arr.ctypes.data_as(ctypes.POINTER(t))

    get_lib().wtpu_vp8_recon_frame_arrays(
        p(cf, ctypes.c_int16), p(md, ctypes.c_uint8),
        mb_w, mb_h, st.filter_type, p(finfo, ctypes.c_int32),
        p(Y, ctypes.c_uint8), p(U, ctypes.c_uint8), p(V, ctypes.c_uint8))
    W, H = st.width, st.height
    return (Y[:H, :W], U[: (H + 1) // 2, : (W + 1) // 2],
            V[: (H + 1) // 2, : (W + 1) // 2])


def yuv_planes_to_rgba(y: np.ndarray, u: np.ndarray,
                       v: np.ndarray) -> np.ndarray:
    """Host YUV 4:2:0 planes → (H, W, 4) RGBA (alpha 255): the native
    fused fancy upsample and BT.601 conversion, the same arithmetic as
    the yuv420_to_rgba kernel."""
    H, W = y.shape
    yc = np.ascontiguousarray(y, np.uint8)
    uc = np.ascontiguousarray(u, np.uint8)
    vc = np.ascontiguousarray(v, np.uint8)
    out = np.empty((H, W, 4), np.uint8)

    def u8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    get_lib().wtpu_yuv_to_rgba_fancy(u8(yc), u8(uc), u8(vc), W, H,
                                     yc.shape[1], uc.shape[1], u8(out))
    return out


# ---------------------------------------------------------------------------
# Chroma dithering (libwebp's VP8InitDithering and DitherRow; RFC 6386 has
# none): after the loop filter, each flat-chroma MB (modes[:, 4], the
# symbol engine's dither flag) of a segment whose amplitude reaches
# _MIN_DITHER_AMP gets 64 draws of a serial generator on U, then 64 on V,
# in MB raster order.  The draws are made here, on the host; the device
# adds them to the filtered planes (decode.py).
# ---------------------------------------------------------------------------

# Per-uv-quant dither amplitude ("roughly dqm.uv_mat[1]").
_QUANT_TO_DITHER_AMP = (8, 7, 6, 4, 4, 2, 2, 2, 1, 1, 1, 1)
_MIN_DITHER_AMP = 4

# libwebp's published VP8Random seed table (31-bit values); a format-
# behaviour constant needed for bit-exact dithered output.
_RANDOM_TABLE = (
    0x0de15230, 0x03b31886, 0x775faccb, 0x1c88626a, 0x68385c55, 0x14b3b828,
    0x4a85fef8, 0x49ddb84b, 0x64fcf397, 0x5c550289, 0x4a290000, 0x0d7ec1da,
    0x5940b7ab, 0x5492577d, 0x4e19ca72, 0x38d38c69, 0x0c01ee65, 0x32a1755f,
    0x5437f652, 0x5abb2c32, 0x0faa57b1, 0x73f533e7, 0x685feeda, 0x7563cce2,
    0x6e990e83, 0x4730a7ed, 0x4fc0d9c6, 0x496b153c, 0x4f1403fa, 0x541afb0c,
    0x73990b32, 0x26d7cb1c, 0x6fcc3706, 0x2cbb77d8, 0x75762f2a, 0x6425ccdd,
    0x24b35461, 0x0a7d8715, 0x220414a8, 0x141ebf67, 0x56b41583, 0x73e502e3,
    0x44cab16f, 0x28264d42, 0x73baaefb, 0x0a50ebed, 0x1d6ab6fb, 0x0d3ad40b,
    0x35db3b68, 0x2b081e83, 0x77ce6b95, 0x5181e5f0, 0x78853bbc, 0x009f9494,
    0x27e5ed3c,
)


class VP8Random:
    """Knuth's subtractive lagged-Fibonacci generator: x[t + 55] =
    x[t] - x[t + 31] mod 2^31 over the 55-entry table."""

    def __init__(self):
        self.tab = list(_RANDOM_TABLE)
        self.i1, self.i2 = 0, 31

    def bits2(self, num_bits: int, amp: int) -> int:
        """One draw, centred on 1 << (num_bits - 1), amplitude amp/256."""
        return int(_centre(np.array([self.raw(1)[0]]), num_bits, amp)[0])

    def raw(self, n: int) -> np.ndarray:
        """The next ``n`` 31-bit table values (int64), advancing the state
        as ``n`` calls of ``bits2`` do; 24 at a time, the generator's
        shortest lag."""
        x = np.empty(55 + n, np.int64)
        x[:55] = np.roll(np.array(self.tab, np.int64), -self.i1)
        for t in range(0, n, 24):
            e = min(t + 24, n)
            x[55 + t:55 + e] = (x[t:e] - x[t + 31:e + 31]) & 0x7FFFFFFF
        self.tab = list(np.roll(x[n:], self.i1 + n).tolist())
        self.i1 = (self.i1 + n) % 55
        self.i2 = (self.i1 + 31) % 55
        return x[55:]


def _centre(raw: np.ndarray, num_bits: int, amp) -> np.ndarray:
    """bits2's mapping of raw values: sign-extended after << 1, scaled by
    amp / 256, recentred."""
    d = (raw << 1) & 0xFFFFFFFF
    d = np.where(d & 0x80000000, d - (1 << 32), d) >> (32 - num_bits)
    return ((d * amp) >> 8) + (1 << (num_bits - 1))


def _dither_amps(st: FrameState, strength: int) -> list:
    """Per-segment dither amplitudes (VP8InitDithering)."""
    f = 0 if strength < 0 else (255 if strength > 100 else
                                strength * 255 // 100)
    amps = [0, 0, 0, 0]
    if f > 0:
        for s, m in enumerate(st.dqm):
            if m.uv_quant < len(_QUANT_TO_DITHER_AMP):
                idx = max(m.uv_quant, 0)
                amps[s] = (f * _QUANT_TO_DITHER_AMP[idx]) >> 3
    return amps


def dither_deltas(st: FrameState, modes: np.ndarray, strength: int):
    """The chroma dither of one frame as per-pixel deltas: (dU, dV) int16
    (8*mb_h, 8*mb_w) planes, ``clip(p + d)`` of the filtered U/V planes
    giving the dithered ones; None when no MB is dithered."""
    amps = np.array(_dither_amps(st, strength), np.int64)
    if not amps.any():
        return None
    amp = np.where(modes[:, 4] != 0, amps[modes[:, 2]], 0)
    mbs = np.flatnonzero(amp >= _MIN_DITHER_AMP)
    if mbs.size == 0:
        return None
    noise = _centre(VP8Random().raw(128 * mbs.size).reshape(-1, 2, 8, 8), 8,
                    amp[mbs][:, None, None, None])
    delta = (noise - 128 + 8) >> 4                       # (n, 2, 8, 8)
    out = np.zeros((2, st.mb_h * st.mb_w, 8, 8), np.int16)
    out[:, mbs] = delta.transpose(1, 0, 2, 3)
    planes = out.reshape(2, st.mb_h, st.mb_w, 8, 8).transpose(0, 1, 3, 2, 4)
    planes = planes.reshape(2, 8 * st.mb_h, 8 * st.mb_w)
    return planes[0], planes[1]


__all__ = [
    "FrameState",
    "VP8Random",
    "dither_deltas",
    "decode_vp8_symbols",
    "decode_vp8_symbols_batch",
    "parse_frame_header",
    "mb_symbols",
    "recon_vp8_yuv_host",
    "symbol_engine",
    "vp8_filter_params",
    "yuv_planes_to_rgba",
]
