"""Plain parse of a lossy WebP file: its VP8 chunk (container.py), the
frame header, the first partition (segment, filter and quantizer headers, token
probabilities, every macroblock's modes) and the coefficient tokens.

Written from RFC 6386 (sections 9, 13, 19, 20) in plain Python and NumPy
as the benchmark's reference; it shares no code with the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
# 4x4 intra modes, in the order the mode tree and the probability table use
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# 16x16 and chroma modes share the first four numbers
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
BMODE_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
              -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)
CATS = (T.CAT3, T.CAT4, T.CAT5, T.CAT6)
# left shift that brings a range of 1..255 back to 128..255
_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]


class StreamError(ValueError):
    """The bytes are not a lossy WebP file this reference reads."""


class BoolReader:
    """The boolean entropy decoder (RFC 6386 section 7), with the range
    kept as range - 1 and a 56-bit refill."""

    __slots__ = ("buf", "pos", "value", "bits", "rng")

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf = bytes(buf[start:end]) + bytes(8)
        self.pos = 0
        self.value = 0
        self.bits = -8
        self.rng = 254

    def _fill(self):
        # past the end the stream reads as zero bits
        self.value = (self.value << 56) | int.from_bytes(
            self.buf[self.pos:self.pos + 7].ljust(7, b"\0"), "big")
        self.pos += 7
        self.bits += 56

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._fill()
        rng = self.rng
        split = (rng * prob) >> 8
        bits = self.bits
        if (self.value >> bits) > split:
            rng -= split
            self.value -= (split + 1) << bits
            b = 1
        else:
            rng = split + 1
            b = 0
        sh = _NORM[rng]
        self.rng = (rng << sh) - 1
        self.bits = bits - sh
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def flagged_signed(self, n: int) -> int:
        return self.signed(n) if self.literal(1) else 0


@dataclass
class Frame:
    width: int
    height: int
    mb_w: int
    mb_h: int
    partitions: int
    simple: int                 # loop filter type bit: 1 simple, 0 normal
    level: int
    sharpness: int
    use_segment: int
    update_map: int
    absolute_delta: int
    seg_quant: list
    seg_filter: list
    use_lf_delta: int
    ref_lf_delta: list
    mode_lf_delta: list
    base_q: int
    q_deltas: tuple             # y1_dc, y2_dc, y2_ac, uv_dc, uv_ac
    quant_index: np.ndarray     # (4,) the quantizer index of each segment
    steps: np.ndarray           # (4, 6) y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac
    segment: np.ndarray         # (mb_h, mb_w)
    skip: np.ndarray            # the coded skip flag
    is_i4: np.ndarray
    ymode: np.ndarray           # 16x16 mode of an i16 macroblock
    imodes: np.ndarray          # (mb_h, mb_w, 16) 4x4 modes of an i4 one
    uvmode: np.ndarray
    levels: np.ndarray | None = None   # (mb_h, mb_w, 25, 16) raster


def vp8_payload(data: bytes) -> bytes:
    """The VP8 chunk of a simple or extended lossy file."""
    from .container import read_still

    still = read_still(data)
    if still.kind != "vp8":
        raise StreamError("a lossless file has no VP8 chunk")
    return still.payload


def _quant_steps(q: int, d: tuple) -> list:
    def clip(v, hi=127):
        return min(max(v, 0), hi)
    y2_ac = int(T.AC_QUANT[clip(q + d[2])]) * 101581 >> 16
    return [int(T.DC_QUANT[clip(q + d[0])]), int(T.AC_QUANT[clip(q)]),
            int(T.DC_QUANT[clip(q + d[1])]) * 2, max(y2_ac, 8),
            int(T.DC_QUANT[clip(q + d[3], 117)]),
            int(T.AC_QUANT[clip(q + d[4])])]


def parse(data: bytes, tokens: bool = True) -> Frame:
    """Frame header and first partition of a lossy file; with ``tokens``
    the levels too."""
    return parse_frame(vp8_payload(data), tokens)


def parse_frame(vp8: bytes, tokens: bool = True) -> Frame:
    """``parse`` of a VP8 chunk's payload."""
    if len(vp8) < 10:
        raise StreamError("VP8 chunk too short")
    tag = vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)
    if tag & 1:
        raise StreamError("not a key frame")
    if (tag >> 1) & 7 > 3:
        raise StreamError("unknown VP8 version")
    if not (tag >> 4) & 1:
        raise StreamError("frame not shown")
    part0 = tag >> 5
    if vp8[3:6] != b"\x9d\x01\x2a":
        raise StreamError("bad start code")
    width = (vp8[6] | (vp8[7] << 8)) & 0x3FFF
    height = (vp8[8] | (vp8[9] << 8)) & 0x3FFF
    if width == 0 or height == 0:
        raise StreamError("empty frame")
    if 10 + part0 > len(vp8):
        raise StreamError("truncated first partition")
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    br = BoolReader(vp8, 10, 10 + part0)
    br.literal(1)                       # colour space
    br.literal(1)                       # clamping type
    use_segment = br.literal(1)
    update_map = absolute = 0
    seg_quant, seg_filter, seg_probs = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.literal(1)
        if br.literal(1):               # segment data
            absolute = br.literal(1)
            seg_quant = [br.flagged_signed(7) for _ in range(4)]
            seg_filter = [br.flagged_signed(6) for _ in range(4)]
        if update_map:
            seg_probs = [br.literal(8) if br.literal(1) else 255
                         for _ in range(3)]
    simple = br.literal(1)
    level = br.literal(6)
    sharpness = br.literal(3)
    use_lf_delta = br.literal(1)
    ref_d, mode_d = [0] * 4, [0] * 4
    if use_lf_delta and br.literal(1):
        ref_d = [br.flagged_signed(6) for _ in range(4)]
        mode_d = [br.flagged_signed(6) for _ in range(4)]
    partitions = 1 << br.literal(2)
    base_q = br.literal(7)
    dq = tuple(br.flagged_signed(4) for _ in range(5))
    qidx = []
    for s in range(4):
        if use_segment:
            q = seg_quant[s] + (0 if absolute else base_q)
        else:
            q = base_q
        qidx.append(min(max(q, 0), 127))
    steps = np.array([_quant_steps(q, dq) for q in qidx], np.int64)
    br.literal(1)                       # refresh entropy probabilities
    probas = T.COEFF_PROBAS.copy()
    upd = T.COEFF_UPDATE_PROBAS
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(upd[t, b, c, p])):
                        probas[t, b, c, p] = br.literal(8)
    use_skip = br.literal(1)
    skip_p = br.literal(8) if use_skip else 0

    segment = np.zeros((mb_h, mb_w), np.int64)
    skip = np.zeros((mb_h, mb_w), np.int64)
    is_i4 = np.zeros((mb_h, mb_w), np.int64)
    ymode = np.zeros((mb_h, mb_w), np.int64)
    imodes = np.zeros((mb_h, mb_w, 16), np.int64)
    uvmode = np.zeros((mb_h, mb_w), np.int64)
    kf = T.KF_BMODE_PROBAS.tolist()
    top = [[B_DC] * 4 for _ in range(mb_w)]
    for my in range(mb_h):
        left = [B_DC] * 4
        for mx in range(mb_w):
            if update_map:
                segment[my, mx] = (br.bit(seg_probs[2]) + 2
                                   if br.bit(seg_probs[0])
                                   else br.bit(seg_probs[1]))
            if use_skip:
                skip[my, mx] = br.bit(skip_p)
            tp = top[mx]
            if br.bit(145):
                if br.bit(156):
                    m = TM_PRED if br.bit(128) else H_PRED
                else:
                    m = V_PRED if br.bit(163) else DC_PRED
                ymode[my, mx] = m
                imodes[my, mx] = m
                tp[:] = [m] * 4
                left = [m] * 4
            else:
                is_i4[my, mx] = 1
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        prob = kf[tp[x]][m]
                        i = BMODE_TREE[br.bit(prob[0])]
                        while i > 0:
                            i = BMODE_TREE[2 * i + br.bit(prob[i])]
                        m = -i
                        tp[x] = m
                        imodes[my, mx, 4 * y + x] = m
                    left[y] = m
            uvmode[my, mx] = (DC_PRED if not br.bit(142) else
                              V_PRED if not br.bit(114) else
                              TM_PRED if br.bit(183) else H_PRED)
    fr = Frame(width, height, mb_w, mb_h, partitions, simple, level,
               sharpness, use_segment, update_map, absolute, seg_quant,
               seg_filter, use_lf_delta, ref_d, mode_d, base_q, dq,
               np.array(qidx, np.int64), steps, segment, skip, is_i4, ymode,
               imodes, uvmode)
    if tokens:
        fr.levels = _tokens(vp8, 10 + part0, fr, probas, use_skip)
    return fr


def _partitions(vp8: bytes, start: int, n: int):
    sizes_at = start
    pos = start + 3 * (n - 1)
    if pos > len(vp8):
        raise StreamError("truncated partition table")
    spans = []
    for i in range(n):
        if i < n - 1:
            j = sizes_at + 3 * i
            size = vp8[j] | (vp8[j + 1] << 8) | (vp8[j + 2] << 16)
        else:
            size = len(vp8) - pos
        if size < 0 or pos + size > len(vp8):
            raise StreamError("truncated token partition")
        spans.append((pos, pos + size))
        pos += size
    return spans


def _coeffs(br: BoolReader, probas, t: int, ctx: int, first: int, out: list):
    """One block's tokens into ``out`` (16 raster levels); returns the
    index after the last non-zero one (``first`` when there is none)."""
    bit = br.bit
    band = probas[t]
    n = first
    p = band[BANDS[n]][ctx]
    while n < 16:
        if not bit(p[0]):
            return n                    # end of block
        while not bit(p[1]):            # a zero
            n += 1
            if n == 16:
                return 16
            p = band[BANDS[n]][0]
        if not bit(p[2]):
            v = 1
            nxt = 1
        else:
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                b1 = bit(p[8])
                b0 = bit(p[9 + b1])
                cat = 2 * b1 + b0
                v = 0
                for pr in CATS[cat]:
                    v += v + bit(pr)
                v += 3 + (8 << cat)
            nxt = 2
        out[ZIGZAG[n]] = -v if bit(128) else v
        n += 1
        if n == 16:
            return 16
        p = band[BANDS[n]][nxt]
    return 16


def _tokens(vp8: bytes, start: int, fr: Frame, probas, use_skip: int):
    readers = [BoolReader(vp8, a, b)
               for a, b in _partitions(vp8, start, fr.partitions)]
    pr = probas.tolist()
    mb_w, mb_h = fr.mb_w, fr.mb_h
    levels = np.zeros((mb_h, mb_w, 25, 16), np.int64)
    # non-zero contexts: 4 luma, 2 u, 2 v columns (rows) and the Y2 flag
    top = [[0] * 9 for _ in range(mb_w)]
    for my in range(mb_h):
        br = readers[my & (fr.partitions - 1)]
        left = [0] * 9
        row = [[0] * 16 for _ in range(25 * mb_w)]
        for mx in range(mb_w):
            tp = top[mx]
            i4 = fr.is_i4[my, mx]
            if use_skip and fr.skip[my, mx]:
                for k in range(8):
                    tp[k] = left[k] = 0
                if not i4:
                    tp[8] = left[8] = 0
                continue
            blocks = row[25 * mx:25 * mx + 25]
            if not i4:
                nz = _coeffs(br, pr, 1, tp[8] + left[8], 0, blocks[24])
                tp[8] = left[8] = int(nz > 0)
                first, t = 1, 0
            else:
                first, t = 0, 3
            for y in range(4):
                for x in range(4):
                    nz = _coeffs(br, pr, t, tp[x] + left[y], first,
                                 blocks[4 * y + x])
                    tp[x] = left[y] = int(nz > first)
            for ch in (0, 2):
                for y in range(2):
                    for x in range(2):
                        nz = _coeffs(br, pr, 2, tp[4 + ch + x]
                                     + left[4 + ch + y], 0,
                                     blocks[16 + 2 * ch + 2 * y + x])
                        tp[4 + ch + x] = left[4 + ch + y] = int(nz > 0)
        levels[my] = np.array(row, np.int64).reshape(mb_w, 25, 16)
    return levels
