"""VP8L (WebP lossless) decoder, host side.

Python reads the headers (transforms, colour cache, meta prefix codes);
the native layer (entropy/native/vp8l_dec.cpp, GIL released) reads the
prefix-code section, runs the per-pixel Huffman/LZ77/colour-cache loop
and the inverse transforms, and repacks ARGB as RGBA.  The batch decode
runs ``decode_vp8l`` in its host thread pool; ``decode_vp8l_alpha``
decodes the 8-bit stream of an ALPH chunk.  Written from the lossless
bitstream spec.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ...constants import (
    COLOR_INDEXING_TRANSFORM,
    COLOR_TRANSFORM,
    NUM_DISTANCE_CODES,
    NUM_LENGTH_CODES,
    NUM_LITERAL_CODES,
    PREDICTOR_TRANSFORM,
    SUBTRACT_GREEN_TRANSFORM,
    VP8L_SIGNATURE,
)
from ...entropy.bitio import BitReader
from ...entropy.native_loader import get_lib
from ...errors import BitstreamError
from . import transforms_np as tnp


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
                         top_level: bool) -> _StreamHeader:
    """Everything before the pixel loop."""
    hdr = _StreamHeader()
    transforms: list[Transform] = []
    seen: set[int] = set()
    cur_xsize = xsize
    if top_level:
        while br.read_bit():
            t, cur_xsize = _read_transform(br, cur_xsize, ysize, seen)
            transforms.append(t)
            if len(transforms) > 4:
                raise BitstreamError("too many transforms")

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

    hdr.transforms = transforms
    hdr.cur_xsize = cur_xsize
    hdr.cache_bits = cache_bits
    hdr.huffman_image = huffman_image
    hdr.huffman_bits = huffman_bits
    hdr.lengths = _read_prefix_groups(br, num_groups, cache_bits)
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


__all__ = ["decode_vp8l", "decode_vp8l_alpha", "decode_vp8l_header"]
