"""ALPH chunk decoding and encoding (the alpha plane of a lossy WebP file).

Header byte: bits 0-1 compression method (0=raw, 1=VP8L 8-bit stream),
bits 2-3 spatial filter (none/horizontal/vertical/gradient), bits 4-5
pre-processing (0=none, 1=quantized levels), bits 6-7 reserved.  The
filter's inverse runs in the native layer (entropy/native/alpha_dec.cpp:
the gradient filter is a per-pixel recurrence); the level smoothing in
numpy float64.  The encoder filters the plane (numpy), then stores it
raw or as a VP8L stream (models/vp8l/encoder.py).  Written from the WebP
container spec.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...entropy.native_loader import get_lib
from ...errors import BitstreamError

FILTER_NONE = 0
FILTER_HORIZONTAL = 1
FILTER_VERTICAL = 2
FILTER_GRADIENT = 3


def _unfilter(method: int, data: np.ndarray) -> np.ndarray:
    """Invert the alpha spatial filter, row-sequential, mod-256 exact."""
    if method == FILTER_NONE:
        return data
    h, w = data.shape
    out = np.array(data, np.uint8, order="C")
    get_lib().wtpu_alpha_unfilter(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, method)
    return out


def decode_alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """ALPH chunk payload → (height, width) uint8 alpha plane."""
    if len(payload) < 1:
        raise BitstreamError("empty ALPH chunk")
    hdr = payload[0]
    method = hdr & 0x03
    filter_m = (hdr >> 2) & 0x03
    pre_processing = (hdr >> 4) & 0x03
    rsrv = (hdr >> 6) & 0x03
    if rsrv != 0 or method > 1:
        raise BitstreamError("bad ALPH header")
    data = payload[1:]
    if method == 0:  # uncompressed
        if len(data) < width * height:
            raise BitstreamError("raw alpha data too short")
        plane = np.frombuffer(data[: width * height], np.uint8).reshape(height, width)
    else:  # VP8L-compressed 8-bit stream (values in the green channel)
        from ..vp8l.decoder import decode_vp8l_alpha

        plane = decode_vp8l_alpha(data, width, height)
    plane = _unfilter(filter_m, plane)
    if pre_processing == 1:
        plane = dequantize_levels(plane)
    return plane


def dequantize_levels(plane: np.ndarray) -> np.ndarray:
    """Smooth a level-quantized plane: low-pass it (a 5x5 box in
    float64), then constrain each pixel to half a level-step around its
    coded value so the result still decodes to the same levels."""
    levels = np.unique(plane)
    if len(levels) < 2 or len(levels) > 16:
        return plane
    step = int(np.diff(levels.astype(np.int32)).min())
    radius = 2
    p = np.pad(plane.astype(np.float64), radius, mode="edge")
    acc = np.zeros_like(p[radius:-radius, radius:-radius])
    n = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            acc += p[radius + dy : p.shape[0] - radius + dy,
                     radius + dx : p.shape[1] - radius + dx]
            n += 1
    sm = acc / n
    half = step // 2
    lo = plane.astype(np.int32) - half
    hi = plane.astype(np.int32) + half
    return np.clip(np.rint(sm), lo, hi).clip(0, 255).astype(np.uint8)


def encode_alpha(plane: np.ndarray, *, method: int = 1, quality: int = 100,
                 filtering_level: int = 1) -> bytes:
    """(H, W) uint8 alpha plane → ALPH chunk payload.

    method: 0 = raw, 1 = VP8L stream.  filtering_level: 0 = none, 1 =
    the smaller of none and gradient, 2 = the smallest of all four
    spatial filters.  quality < 100 first
    reduces the plane's levels.
    """
    if quality < 100:
        from ..vp8l.near_lossless import quantize_alpha_levels

        plane = quantize_alpha_levels(plane, quality)

    def encode_with(fm: int) -> bytes:
        filtered = _filter(fm, plane)
        hdr = (method & 3) | ((fm & 3) << 2)
        if method == 0:
            return bytes([hdr]) + filtered.tobytes()
        from ..vp8l.encoder import encode_vp8l_alpha

        return bytes([hdr]) + encode_vp8l_alpha(filtered)

    if filtering_level == 0:
        return encode_with(FILTER_NONE)
    if filtering_level == 1:
        return min(
            (encode_with(FILTER_NONE), encode_with(FILTER_GRADIENT)), key=len
        )
    return min((encode_with(f) for f in range(4)), key=len)


def _filter(method: int, data: np.ndarray) -> np.ndarray:
    """Forward alpha spatial filter (encoder side)."""
    if method == FILTER_NONE:
        return data
    d = data.astype(np.int64)
    out = np.zeros_like(d)
    out[0, 0] = d[0, 0]
    out[0, 1:] = d[0, 1:] - d[0, :-1]
    if method == FILTER_HORIZONTAL:
        out[1:, 0] = d[1:, 0] - d[:-1, 0]
        out[1:, 1:] = d[1:, 1:] - d[1:, :-1]
    elif method == FILTER_VERTICAL:
        out[1:] = d[1:] - d[:-1]
    elif method == FILTER_GRADIENT:
        out[1:, 0] = d[1:, 0] - d[:-1, 0]
        grad = d[1:, :-1] + d[:-1, 1:] - d[:-1, :-1]
        out[1:, 1:] = d[1:, 1:] - np.clip(grad, 0, 255)
    else:
        raise ValueError("bad filter")
    return (out & 0xFF).astype(np.uint8)


__all__ = ["decode_alpha", "dequantize_levels", "encode_alpha"]
