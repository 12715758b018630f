"""Plain decode of a WebP lossless (VP8L) bitstream, and of the VP8L-coded
plane of an ALPH chunk.

Written from RFC 9649 (WebP Image Format, section 3 "Specification for
WebP Lossless Bitstream") in plain Python and NumPy as the benchmark's
reference; it shares no code with the program.  It covers every part of
the format: normal and simple prefix codes, meta prefix codes (the entropy
image), LZ77 backward references with the 120-entry distance map, the
colour cache, and the four transforms (predictor with all 14 modes,
cross-colour, subtract-green, and colour indexing with pixel bundling).
"""

from __future__ import annotations

import numpy as np

from .bitstream import StreamError

PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# RFC 9649 section 3.5.2.2: distance codes 1..120 as (xi, yi) offsets
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
HASH_MUL = 0x1E35A7BD
BLACK = (255, 0, 0, 0)                  # ARGB 0xff000000


class BitReader:
    """LSB-first bit reader.  ``win[i]`` holds the 32 bits that start at
    byte i, so a read of up to 25 bits at any position is one lookup."""

    def __init__(self, buf: bytes):
        n = len(buf)
        b = np.frombuffer(bytes(buf) + bytes(8), np.uint8).astype(np.uint64)
        self.win = (b[:n + 4] | (b[1:n + 5] << 8) | (b[2:n + 6] << 16)
                    | (b[3:n + 7] << 24)).tolist()
        self.pos = 0
        self.end = 8 * n

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.end:
            raise StreamError("VP8L stream ends early")


def prefix_table(lengths) -> tuple:
    """(table, mask) of a canonical prefix code given its code lengths:
    ``table[peek & mask]`` is symbol << 4 | length, where peek holds the
    next bits, first bit lowest.  A code of one symbol reads no bits."""
    lengths = np.asarray(lengths, np.int64)
    syms = np.flatnonzero(lengths)
    if len(syms) == 0:
        raise StreamError("prefix code with no symbol")
    if len(syms) == 1:
        return [int(syms[0]) << 4], 0
    lens = lengths[syms]
    top = int(lens.max())
    if int((1 << (top - lens)).sum()) != 1 << top:
        raise StreamError("prefix code is not complete")
    table = np.zeros(1 << top, np.int64)
    code = 0
    for n in range(1, top + 1):
        s = syms[lens == n]
        codes = code + np.arange(len(s))
        code = (code + len(s)) << 1
        if not len(s):
            continue
        rev = np.zeros_like(codes)
        for i in range(n):                  # codes are read first bit first
            rev |= ((codes >> i) & 1) << (n - 1 - i)
        idx = rev[:, None] + (np.arange(1 << (top - n)) << n)[None, :]
        table[idx] = ((s << 4) | n)[:, None]
    return table.tolist(), (1 << top) - 1


def _symbol(br: BitReader, code: tuple) -> int:
    table, mask = code
    p = br.pos
    e = table[(br.win[p >> 3] >> (p & 7)) & mask]
    br.pos = p + (e & 15)
    return e >> 4


def read_prefix_code(br: BitReader, alphabet: int) -> tuple:
    """One prefix code of an alphabet of ``alphabet`` symbols."""
    lengths = [0] * alphabet
    if br.read(1):                          # simple code: 1 or 2 symbols
        n = br.read(1) + 1
        syms = [br.read(8 if br.read(1) else 1)]
        if n == 2:
            syms.append(br.read(8))
        for s in syms:
            if s >= alphabet:
                raise StreamError("simple code symbol outside its alphabet")
            lengths[s] = 1
        return prefix_table(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    clcode = prefix_table(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise StreamError("max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    s, prev = 0, 8
    while s < alphabet and max_symbol > 0:
        max_symbol -= 1
        c = _symbol(br, clcode)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        rep = br.read(extra) + offset
        if s + rep > alphabet:
            raise StreamError("code length repeat past the alphabet")
        lengths[s:s + rep] = [prev if c == 16 else 0] * rep
        s += rep
    return prefix_table(lengths)


def _prefix_value(br: BitReader, code: int) -> int:
    """A length or distance from its prefix code and extra bits."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + br.read(extra) + 1


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def decode_pixels(br: BitReader, w: int, h: int, level0: bool) -> np.ndarray:
    """An entropy-coded image (``level0``: the main image, with its meta
    prefix codes) of w x h pixels as a flat uint32 ARGB array."""
    cbits = 0
    if br.read(1):
        cbits = br.read(4)
        if not 1 <= cbits <= 11:
            raise StreamError(f"colour cache of {cbits} bits")
    ebits, rows = 31, [[0]]              # no meta codes: one block
    if level0 and br.read(1):
        ebits = br.read(3) + 2
        ew = _sub(w, ebits)
        ent = (decode_pixels(br, ew, _sub(h, ebits), False) >> 8) & 0xFFFF
        rows = ent.reshape(-1, ew).tolist()
        ngroups = int(ent.max()) + 1
    else:
        ngroups = 1
    sizes = (256 + 24 + ((1 << cbits) if cbits else 0), 256, 256, 256, 40)
    groups = [tuple(c for a in sizes for c in read_prefix_code(br, a))
              for _ in range(ngroups)]
    n = w * h
    out = [0] * n
    cache = [0] * (1 << cbits) if cbits else None
    shift = 32 - cbits
    emask = (1 << ebits) - 1
    win = br.win
    pos = br.pos
    p = x = y = 0
    erow = rows[0]
    tg, mg, tr, mr, tb, mb, ta, ma, td, md = groups[erow[0]]
    while p < n:
        e = tg[(win[pos >> 3] >> (pos & 7)) & mg]
        pos += e & 15
        s = e >> 4
        if s < 256:                     # a literal: green, red, blue, alpha
            e = tr[(win[pos >> 3] >> (pos & 7)) & mr]
            pos += e & 15
            r = e >> 4
            e = tb[(win[pos >> 3] >> (pos & 7)) & mb]
            pos += e & 15
            b = e >> 4
            e = ta[(win[pos >> 3] >> (pos & 7)) & ma]
            pos += e & 15
            argb = ((e >> 4) << 24) | (r << 16) | (s << 8) | b
            out[p] = argb
            p += 1
            if cache is not None:
                cache[((argb * HASH_MUL) & 0xFFFFFFFF) >> shift] = argb
            x += 1
        elif s < 280:                   # a backward reference
            br.pos = pos
            length = _prefix_value(br, s - 256)
            e = td[(win[br.pos >> 3] >> (br.pos & 7)) & md]
            br.pos += e & 15
            d = _prefix_value(br, e >> 4)
            pos = br.pos
            if d > 120:
                d -= 120
            else:
                xi, yi = DISTANCE_MAP[d - 1]
                d = max(xi + yi * w, 1)
            src = p - d
            if src < 0 or p + length > n:
                raise StreamError("backward reference outside the image")
            if d >= length:
                out[p:p + length] = out[src:src + length]
            else:
                for k in range(length):
                    out[p + k] = out[src + k]
            if cache is not None:
                for argb in out[p:p + length]:
                    cache[((argb * HASH_MUL) & 0xFFFFFFFF) >> shift] = argb
            p += length
            x += length
        else:                           # a colour cache entry
            out[p] = cache[s - 280]     # already in its own slot
            p += 1
            x += 1
        if x >= w:
            y += x // w
            x %= w
            if p < n:
                erow = rows[y >> ebits]
        if p < n and (s >= 256 and s < 280 or not x & emask):
            tg, mg, tr, mr, tb, mb, ta, ma, td, md = groups[
                erow[x >> ebits]]
    br.pos = pos
    br.check()
    return np.array(out, np.uint32)


def _channels(argb: np.ndarray) -> np.ndarray:
    """Flat uint32 ARGB -> (N, 4) int32 channels A, R, G, B."""
    a = argb.astype(np.int64)
    return np.stack([a >> 24, (a >> 16) & 255, (a >> 8) & 255, a & 255],
                    axis=1).astype(np.int32)


def _avg(a, b):
    return (a + b) >> 1


def predictor_inverse(res: np.ndarray, w: int, h: int, bits: int,
                      data: np.ndarray) -> np.ndarray:
    """Undo the predictor transform.  ``res`` is the (h*w, 4) residual
    image, ``data`` the transform's image (mode in its green byte).  Pixel
    (x, y) needs (x-1, y) and (x-1..x+1, y-1), so the pixels of one
    anti-diagonal x + 2y = t are predicted together."""
    out = res.copy()
    out[0] = (out[0] + BLACK) & 255
    out[:w] = np.cumsum(out[:w], axis=0) & 255          # row 0: L
    out[::w] = np.cumsum(out[::w], axis=0) & 255        # column 0: T
    if w < 2 or h < 2:
        return out
    modes = ((data >> 8) & 15).astype(np.int64)
    bw = _sub(w, bits)
    black = np.array(BLACK, np.int32)
    for t in range(3, (w - 1) + 2 * (h - 1) + 1):
        ys = np.arange(max(1, (t - w + 2) // 2), min(h - 1, (t - 1) // 2) + 1)
        if not len(ys):
            continue
        xs = t - 2 * ys
        p = ys * w + xs
        L, T, TR, TL = out[p - 1], out[p - w], out[p - w + 1], out[p - w - 1]
        a_lt = _avg(L, T)
        p_l = np.abs(T - TL).sum(1)
        p_tl = np.abs(L - TL).sum(1)
        d = a_lt - TL
        cand = np.stack([
            np.broadcast_to(black, L.shape), L, T, TR, TL,
            _avg(_avg(L, TR), T), _avg(L, TL), a_lt, _avg(TL, T),
            _avg(T, TR), _avg(_avg(L, TL), _avg(T, TR)),
            np.where((p_tl <= p_l)[:, None], T, L),
            np.clip(L + T - TL, 0, 255),
            np.clip(a_lt + ((d + (d < 0)) >> 1), 0, 255),   # C's d / 2
            np.broadcast_to(black, L.shape), np.broadcast_to(black, L.shape)])
        m = modes[(ys >> bits) * bw + (xs >> bits)]
        out[p] = (out[p] + cand[m, np.arange(len(p))]) & 255
    return out


def cross_color_inverse(img: np.ndarray, w: int, h: int, bits: int,
                        data: np.ndarray) -> np.ndarray:
    m = data.astype(np.int64)
    tile = ((np.arange(h)[:, None] >> bits) * _sub(w, bits)
            + (np.arange(w)[None, :] >> bits)).ravel()

    def s8(v):
        return ((v & 255) ^ 128) - 128

    g2r, g2b, r2b = s8(m[tile]), s8(m[tile] >> 8), s8(m[tile] >> 16)
    out = img.copy()
    g = s8(img[:, 2].astype(np.int64))
    r = (img[:, 1] + ((g2r * g) >> 5)) & 255
    b = img[:, 3] + ((g2b * g) >> 5) + ((r2b * s8(r)) >> 5)
    out[:, 1], out[:, 3] = r, b & 255
    return out


def subtract_green_inverse(img: np.ndarray) -> np.ndarray:
    out = img.copy()
    out[:, 1] = (img[:, 1] + img[:, 2]) & 255
    out[:, 3] = (img[:, 3] + img[:, 2]) & 255
    return out


def color_indexing_inverse(img: np.ndarray, w: int, h: int, bits: int,
                           palette: np.ndarray) -> np.ndarray:
    """Packed indices (green byte, 1 << bits to a pixel) -> colours; an
    index past the palette is transparent black."""
    pw = _sub(w, bits)
    g = img[:, 2].reshape(h, pw).astype(np.int64)
    xs = np.arange(w)
    bpp = 8 >> bits
    idx = (g[:, xs >> bits] >> ((xs & ((1 << bits) - 1)) * bpp)) & (
        (1 << bpp) - 1)
    table = np.zeros((256, 4), np.int32)
    table[:len(palette)] = palette
    return table[idx.ravel()]


def decode_image(br: BitReader, w: int, h: int,
                 predictor: bool = True) -> np.ndarray:
    """The main image stream of w x h: transforms, then the entropy-coded
    pixels, then the transforms undone in reverse order.  (h*w, 4) int32
    channels A, R, G, B.  ``predictor=False`` leaves the predictor
    transform's residuals as they are (the control of ``correct``)."""
    transforms, seen, xs = [], set(), w
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise StreamError(f"transform {kind} twice")
        seen.add(kind)
        if kind in (PREDICTOR, CROSS_COLOR):
            bits = br.read(3) + 2
            data = decode_pixels(br, _sub(xs, bits), _sub(h, bits), False)
            transforms.append((kind, xs, bits, data))
        elif kind == COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = np.cumsum(_channels(decode_pixels(br, n, 1, False)),
                            axis=0) & 255           # delta-coded entries
            transforms.append((kind, xs, bits, pal))
            xs = _sub(xs, bits)
        else:
            transforms.append((kind, xs, 0, None))
    img = _channels(decode_pixels(br, xs, h, True))
    for kind, tw, bits, data in reversed(transforms):
        if kind == PREDICTOR and predictor:
            img = predictor_inverse(img, tw, h, bits, data)
        elif kind == CROSS_COLOR:
            img = cross_color_inverse(img, tw, h, bits, data)
        elif kind == SUBTRACT_GREEN:
            img = subtract_green_inverse(img)
        elif kind == COLOR_INDEXING:
            img = color_indexing_inverse(img, tw, h, bits, data)
    return img


def decode_vp8l(payload: bytes, predictor: bool = True) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a VP8L chunk's payload."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise StreamError("not a VP8L stream")
    br = BitReader(payload)
    br.pos = 8
    w, h = br.read(14) + 1, br.read(14) + 1
    br.read(1)                              # alpha_is_used: a hint only
    if br.read(3):
        raise StreamError("unknown VP8L version")
    try:
        img = decode_image(br, w, h, predictor)
    except IndexError:                      # a read past the padding
        raise StreamError("VP8L stream ends early") from None
    return img[:, [1, 2, 3, 0]].reshape(h, w, 4).astype(np.uint8)


def decode_alpha_stream(data: bytes, w: int, h: int) -> np.ndarray:
    """(h, w) uint8 plane of an ALPH chunk's VP8L stream, which has no
    header: the image stream at the frame's size, values in green."""
    try:
        img = decode_image(BitReader(data), w, h)
    except IndexError:
        raise StreamError("VP8L stream ends early") from None
    return img[:, 2].reshape(h, w).astype(np.uint8)
