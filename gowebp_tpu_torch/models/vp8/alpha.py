"""ALPH chunk decoding (the alpha plane of a lossy WebP file).

Header byte: bits 0-1 compression method (0=raw, 1=VP8L 8-bit stream),
bits 2-3 spatial filter (none/horizontal/vertical/gradient), bits 4-5
pre-processing (0=none, 1=quantized levels), bits 6-7 reserved.  The
filter's inverse runs in the native layer (entropy/native/alpha_dec.cpp:
the gradient filter is a per-pixel recurrence); the level smoothing in
numpy float64.  Written from the WebP container spec.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...entropy.native_loader import get_lib
from ...errors import BitstreamError

FILTER_NONE = 0          # then 1 horizontal, 2 vertical, 3 gradient


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


__all__ = ["decode_alpha", "dequantize_levels"]
