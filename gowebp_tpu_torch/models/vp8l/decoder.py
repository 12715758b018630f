"""VP8L (WebP lossless) decoder, host side.

Python reads the headers (transforms, colour cache, meta prefix codes);
the native layer (entropy/native/vp8l_dec.cpp, GIL released) reads the
prefix-code section, runs the per-pixel Huffman/LZ77/colour-cache loop
and the inverse transforms, and repacks ARGB as RGBA.  The batch decode
runs ``decode_vp8l`` in its host thread pool; ``decode_vp8l_alpha``
decodes the 8-bit stream of an ALPH chunk.  ``VP8LIncrementalPixels`` is
the incremental decoder's pixel loop, in Python: it stops where the bytes
that have arrived end and resumes from a checkpoint when more come.
Written from the lossless bitstream spec.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ...constants import (
    COLOR_INDEXING_TRANSFORM,
    COLOR_TRANSFORM,
    HASH_MUL,
    NUM_DISTANCE_CODES,
    NUM_LENGTH_CODES,
    NUM_LITERAL_CODES,
    PREDICTOR_TRANSFORM,
    SUBTRACT_GREEN_TRANSFORM,
    VP8L_SIGNATURE,
)
from ...entropy.bitio import BitReader
from ...entropy.huffman import HuffmanDecodeTable
from ...entropy.native_loader import get_lib
from ...errors import BitstreamError
from . import transforms_np as tnp
from .encoder import DIST_MAP


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _alphabets(cache_bits: int) -> np.ndarray:
    """The five prefix codes' alphabet sizes: green (+ lengths + cache),
    red, blue, alpha, distance."""
    cache_size = (1 << cache_bits) if cache_bits > 0 else 0
    return np.array([NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size,
                     NUM_LITERAL_CODES, NUM_LITERAL_CODES, NUM_LITERAL_CODES,
                     NUM_DISTANCE_CODES], np.int32)


def _read_prefix_groups(br: BitReader, num_groups: int,
                        cache_bits: int) -> np.ndarray:
    """The meta groups' code lengths, (num_groups, sum of the five
    alphabets) int32, read natively; the reader moves past them."""
    data = np.frombuffer(br.data, np.uint8)
    alphabets = _alphabets(cache_bits)
    out = np.zeros((num_groups, int(alphabets.sum())), np.int32)
    bp = ctypes.c_uint64(0)
    rc = get_lib().wtpu_vp8l_read_groups(
        _ptr(data, ctypes.c_uint8), len(data), br.bit_pos, num_groups,
        _ptr(alphabets, ctypes.c_int32), _ptr(out, ctypes.c_int32),
        ctypes.byref(bp))
    if rc == 2:
        raise BitstreamError("truncated huffman code lengths")
    if rc != 0:
        raise BitstreamError("bad huffman code lengths")
    br.bit_pos = bp.value
    return out


def _decode_pixels(br: BitReader, width: int, height: int,
                   lengths: np.ndarray, huffman_image: np.ndarray | None,
                   huffman_bits: int, cache_bits: int) -> np.ndarray:
    """The pixel loop (native): one ARGB uint32 per pixel, (H, W)."""
    alphabets = _alphabets(cache_bits)
    num_groups, stride = lengths.shape
    offsets = (np.arange(num_groups, dtype=np.int32)[:, None] * stride
               + np.concatenate([[0], np.cumsum(alphabets[:-1])])[None, :]
               ).astype(np.int32).reshape(-1)
    lengths = np.ascontiguousarray(lengths, np.int32)
    data = np.frombuffer(br.data, np.uint8)
    out = np.zeros(width * height, np.uint32)
    bit_out = ctypes.c_uint64(0)
    if huffman_image is not None:
        himg = np.ascontiguousarray(huffman_image.reshape(-1), np.int32)
        himg_p = _ptr(himg, ctypes.c_int32)
        meta_w = huffman_image.shape[1]
    else:
        himg_p = None
        meta_w = 0
    rc = get_lib().wtpu_vp8l_decode_pixels(
        _ptr(data, ctypes.c_uint8), len(data), br.bit_pos,
        width, height, num_groups,
        _ptr(alphabets, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32),
        himg_p, huffman_bits, meta_w, cache_bits,
        _ptr(out, ctypes.c_uint32), ctypes.byref(bit_out))
    if rc != 0:
        raise BitstreamError(f"native vp8l decode failed (code {rc})")
    br.bit_pos = bit_out.value
    return out.reshape(height, width)


def plane_code_to_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    dx, dy = DIST_MAP[code - 1]
    dist = dy * xsize + dx
    return dist if dist >= 1 else 1


def _read_prefix_coded_value(br: BitReader, code: int) -> int:
    """Length/distance prefix decode: code → value (1-based)."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    offset = (2 + (code & 1)) << extra
    return offset + br.read_bits(extra) + 1


class _PrefixTables:
    """One meta group's five decode tables (green, red, blue, alpha,
    distance), each built from its row of the native reader's code
    lengths when first read."""

    __slots__ = ("_tables", "_lengths")

    def __init__(self, lengths: np.ndarray, alphabets: np.ndarray):
        ends = np.cumsum(alphabets)
        self._lengths = np.split(lengths, ends[:-1])
        self._tables = [None] * 5

    def _tab(self, i: int) -> HuffmanDecodeTable:
        t = self._tables[i]
        if t is None:
            t = self._tables[i] = HuffmanDecodeTable(self._lengths[i])
        return t

    green = property(lambda self: self._tab(0))
    red = property(lambda self: self._tab(1))
    blue = property(lambda self: self._tab(2))
    alpha = property(lambda self: self._tab(3))
    dist = property(lambda self: self._tab(4))


@dataclass
class Transform:
    kind: int
    bits: int = 0
    data: np.ndarray | None = None   # sub-image (tiles) or palette
    orig_width: int = 0              # xsize before this transform shrank it


def _read_transform(
    br: BitReader, xsize: int, ysize: int, seen: set[int]
) -> tuple[Transform, int]:
    kind = br.read_bits(2)
    if kind in seen:
        raise BitstreamError("duplicate transform")
    seen.add(kind)
    t = Transform(kind=kind, orig_width=xsize)
    new_xsize = xsize
    if kind in (PREDICTOR_TRANSFORM, COLOR_TRANSFORM):
        t.bits = br.read_bits(3) + 2
        tw = tnp.subsample_size(xsize, t.bits)
        th = tnp.subsample_size(ysize, t.bits)
        t.data = _decode_image_stream(br, tw, th, top_level=False)
    elif kind == COLOR_INDEXING_TRANSFORM:
        num_colors = br.read_bits(8) + 1
        t.bits = 0 if num_colors > 16 else (1 if num_colors > 4 else (2 if num_colors > 2 else 3))
        raw = _decode_image_stream(br, num_colors, 1, top_level=False)
        # Palette entries are delta-coded component-wise.
        palette = np.zeros(num_colors, dtype=np.uint32)
        prev = 0
        for i in range(num_colors):
            cur = 0
            for shift in (24, 16, 8, 0):
                c = ((int(raw[0, i]) >> shift) + (prev >> shift)) & 0xFF
                cur |= c << shift
            palette[i] = cur
            prev = cur
        t.data = palette
        new_xsize = tnp.subsample_size(xsize, t.bits)
    elif kind == SUBTRACT_GREEN_TRANSFORM:
        pass
    else:
        raise BitstreamError("bad transform type")
    return t, new_xsize


class _StreamHeader:
    """Parsed transform + entropy-code headers of one image stream."""

    __slots__ = ("transforms", "cur_xsize", "cache_bits", "huffman_image",
                 "huffman_bits", "lengths")


def _parse_stream_header(br: BitReader, xsize: int, ysize: int, *,
                         top_level: bool,
                         trace: dict | None = None) -> _StreamHeader:
    """Everything before the pixel loop.

    With ``trace`` (a dict) the bits of the transforms, of the meta prefix
    image (colour cache bits included) and of the prefix codes are
    stored under "transforms", "meta_huffman" and "huffman_codes" (the
    bit accounting of utils/bittrace.py).
    """
    hdr = _StreamHeader()
    transforms: list[Transform] = []
    seen: set[int] = set()
    cur_xsize = xsize
    p0 = br.bit_pos
    if top_level:
        while br.read_bit():
            t, cur_xsize = _read_transform(br, cur_xsize, ysize, seen)
            transforms.append(t)
            if len(transforms) > 4:
                raise BitstreamError("too many transforms")
    if trace is not None:
        trace["transforms"] = br.bit_pos - p0
        p0 = br.bit_pos

    cache_bits = 0
    if br.read_bit():
        cache_bits = br.read_bits(4)
        if not (1 <= cache_bits <= 11):
            raise BitstreamError("bad color cache bits")

    huffman_image = None
    huffman_bits = 0
    num_groups = 1
    if top_level and br.read_bit():
        huffman_bits = br.read_bits(3) + 2
        hw = tnp.subsample_size(cur_xsize, huffman_bits)
        hh = tnp.subsample_size(ysize, huffman_bits)
        raw = _decode_image_stream(br, hw, hh, top_level=False)
        huffman_image = ((raw >> 8) & 0xFFFF).astype(np.int32)
        num_groups = int(huffman_image.max()) + 1
    if trace is not None:
        trace["meta_huffman"] = br.bit_pos - p0
        p0 = br.bit_pos

    hdr.transforms = transforms
    hdr.cur_xsize = cur_xsize
    hdr.cache_bits = cache_bits
    hdr.huffman_image = huffman_image
    hdr.huffman_bits = huffman_bits
    hdr.lengths = _read_prefix_groups(br, num_groups, cache_bits)
    if trace is not None:
        trace["huffman_codes"] = br.bit_pos - p0
    return hdr


def _apply_inverse_transforms(argb: np.ndarray,
                              transforms: list) -> np.ndarray:
    for t in reversed(transforms):
        if t.kind == COLOR_INDEXING_TRANSFORM:
            argb = tnp.color_index_inverse(argb, t.data, t.orig_width)
        elif t.kind == SUBTRACT_GREEN_TRANSFORM:
            argb = tnp.add_green_inverse(argb)
        elif t.kind == PREDICTOR_TRANSFORM:
            argb = tnp.predictor_inverse(argb, t.data, t.bits)
        elif t.kind == COLOR_TRANSFORM:
            argb = tnp.color_transform_inverse(argb, t.data, t.bits)
    return argb


def _decode_image_stream(
    br: BitReader, xsize: int, ysize: int, *, top_level: bool
) -> np.ndarray:
    """Decode one image stream → (ysize, xsize) ARGB uint32.

    At top level, transforms are read and inverse-applied before returning.
    """
    hdr = _parse_stream_header(br, xsize, ysize, top_level=top_level)
    argb = _decode_pixels(
        br, hdr.cur_xsize, ysize, hdr.lengths, hdr.huffman_image,
        hdr.huffman_bits, hdr.cache_bits
    )
    return _apply_inverse_transforms(argb, hdr.transforms)


class VP8LIncrementalPixels:
    """Resumable VP8L pixel loop for incremental decode.

    Suspend and resume: a checkpoint (bit position, pixel position,
    colour cache) is taken at every SYNC_ROWS-th row boundary; when the
    reader runs off the end of the bytes that have arrived, the state
    rolls back to the last checkpoint and decoding resumes from there
    once more data arrives.  The prefix codes come from the header's
    native code lengths (``hdr.lengths``), one lazily built set of tables
    per meta group.
    """

    SYNC_ROWS = 8

    def __init__(self, width: int, height: int, hdr: _StreamHeader,
                 bit_pos: int):
        self.width = hdr.cur_xsize
        self.height = height
        alphabets = _alphabets(hdr.cache_bits)
        self.groups = [_PrefixTables(row, alphabets) for row in hdr.lengths]
        self.huffman_image = hdr.huffman_image
        self.huffman_bits = hdr.huffman_bits
        self.cache_bits = hdr.cache_bits
        self.transforms = hdr.transforms
        self.npix = self.width * height
        self.pixels = [0] * self.npix
        self.cache = [0] * (1 << hdr.cache_bits) if hdr.cache_bits else None
        self.pos = 0
        self.x = 0
        self.done = False
        # (bit_pos, pos, x, cache snapshot)
        self._ck = (bit_pos, 0, 0, list(self.cache) if self.cache else None)

    def rows_ready(self) -> int:
        return self._ck[1] // self.width if not self.done else self.height

    def resume(self, data: bytes) -> bool:
        """Continue from the last checkpoint over (possibly longer) data.

        Returns True when the whole image has been decoded.
        """
        if self.done:
            return True
        br = BitReader(data)
        br.bit_pos, self.pos, self.x, ck_cache = self._ck
        if self.cache is not None:
            self.cache = list(ck_cache)
        width = self.width
        npix = self.npix
        pixels = self.pixels
        cache = self.cache
        cache_shift = 32 - self.cache_bits if self.cache_bits else 0
        cache_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES
        hufi = self.huffman_image
        hbits = self.huffman_bits
        meta_w = hufi.shape[1] if hufi is not None else 0
        meta_idx = hufi.tolist() if hufi is not None else None
        group = self.groups[0]
        last_group_key = -1
        next_sync = ((self.pos // width) // self.SYNC_ROWS + 1) * self.SYNC_ROWS

        pos = self.pos
        x = self.x
        while pos < npix:
            if hufi is not None:
                key = (pos // width >> hbits) * meta_w + (x >> hbits)
                if key != last_group_key:
                    y = pos // width
                    group = self.groups[meta_idx[y >> hbits][x >> hbits]]
                    last_group_key = key
            sym = group.green.decode(br)
            if br.eos:
                break
            if sym < NUM_LITERAL_CODES:
                red = group.red.decode(br)
                blue = group.blue.decode(br)
                alpha = group.alpha.decode(br)
                if br.eos:
                    break
                argb = (alpha << 24) | (red << 16) | (sym << 8) | blue
                pixels[pos] = argb
                if cache is not None:
                    cache[(HASH_MUL * argb & 0xFFFFFFFF) >> cache_shift] = argb
                pos += 1
                x += 1
                if x >= width:
                    x = 0
            elif sym < cache_limit:
                length = _read_prefix_coded_value(br, sym - NUM_LITERAL_CODES)
                dist_code = group.dist.decode(br)
                dist = plane_code_to_distance(
                    width, _read_prefix_coded_value(br, dist_code)
                )
                if br.eos:
                    break
                if dist > pos:
                    raise BitstreamError("backward reference before image start")
                if pos + length > npix:
                    raise BitstreamError("backward reference overflows image")
                if cache is None:
                    for _ in range(length):
                        pixels[pos] = pixels[pos - dist]
                        pos += 1
                else:
                    for _ in range(length):
                        argb = pixels[pos - dist]
                        pixels[pos] = argb
                        cache[(HASH_MUL * argb & 0xFFFFFFFF)
                              >> cache_shift] = argb
                        pos += 1
                x = pos % width
                last_group_key = -1
            else:
                idx = sym - cache_limit
                if cache is None or idx >= len(cache):
                    raise BitstreamError("color cache symbol without cache")
                pixels[pos] = cache[idx]
                pos += 1
                x += 1
                if x >= width:
                    x = 0
            if x == 0 and pos // width >= next_sync:
                self._ck = (br.bit_pos, pos, 0,
                            list(cache) if cache is not None else None)
                next_sync = (pos // width // self.SYNC_ROWS + 1) * self.SYNC_ROWS
        self.pos = pos
        self.x = x
        if pos >= npix:
            self.done = True
            self._ck = (br.bit_pos, pos, x, None)
            return True
        # Starved mid-symbol: progress past the checkpoint is discarded
        # (the next resume() rolls back to the checkpoint and redoes it).
        return False

    def partial_argb(self) -> np.ndarray:
        """(rows_ready, cur_xsize) ARGB decoded so far (pre-inverse)."""
        rows = self.rows_ready()
        return np.array(self.pixels[: rows * self.width],
                        np.uint32).reshape(rows, self.width)


def decode_vp8l_header(payload: bytes) -> tuple[int, int, bool]:
    if len(payload) < 5 or payload[0] != VP8L_SIGNATURE:
        raise BitstreamError("bad VP8L header")
    br = BitReader(payload[1:])
    width = br.read_bits(14) + 1
    height = br.read_bits(14) + 1
    has_alpha = bool(br.read_bit())
    version = br.read_bits(3)
    if version != 0:
        raise BitstreamError("bad VP8L version")
    return width, height, has_alpha


def decode_vp8l(payload: bytes) -> np.ndarray:
    """Decode a VP8L chunk payload → (H, W, 4) uint8 RGBA."""
    width, height, _ = decode_vp8l_header(payload)
    br = BitReader(payload[1:])
    br.skip_bits(14 + 14 + 1 + 3)
    argb = _decode_image_stream(br, width, height, top_level=True)
    flat = np.ascontiguousarray(argb.reshape(-1), np.uint32)
    out = np.empty((height, width, 4), np.uint8)
    get_lib().wtpu_argb_to_rgba(_ptr(flat, ctypes.c_uint32),
                                _ptr(out, ctypes.c_uint8), flat.size)
    return out


def decode_vp8l_alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """Decode the 8-bit VP8L stream used inside ALPH chunks (no header)."""
    br = BitReader(payload)
    argb = _decode_image_stream(br, width, height, top_level=True)
    return ((argb >> 8) & 0xFF).astype(np.uint8)   # alpha lives in green


__all__ = ["VP8LIncrementalPixels", "decode_vp8l", "decode_vp8l_alpha",
           "decode_vp8l_header", "plane_code_to_distance"]
