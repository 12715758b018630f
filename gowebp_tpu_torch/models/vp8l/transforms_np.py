"""VP8L transforms on packed ARGB planes (host).

The four transforms of the lossless format, decode side: subtract-green
(add_green_inverse), cross-colour (color_transform_inverse), colour
indexing (color_index_inverse) and the 14 spatial predictors
(predictor_inverse).  The predictor inverse is a per-pixel raster
recurrence and runs in the native layer, as do add-green and
cross-colour; colour indexing is a numpy table lookup.  The encoder's
forward subtract-green and cross-colour are numpy (the forward
predictor is the native ``wtpu_vp8l_predictor_residual``).  Written from
the lossless bitstream spec.

Pixels are ARGB packed into uint32: (a<<24)|(r<<16)|(g<<8)|b.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...entropy.native_loader import get_lib


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def subsample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def add_green_inverse(argb: np.ndarray) -> np.ndarray:
    """r += g; b += g (mod 256)."""
    buf = np.ascontiguousarray(argb, np.uint32).copy()
    get_lib().wtpu_vp8l_add_green(_u32(buf), buf.size)
    return buf


def subtract_green_forward(argb: np.ndarray) -> np.ndarray:
    """r -= g; b -= g (mod 256)."""
    g = (argb >> 8) & 0xFF
    r = ((argb >> 16) & 0xFF) - g
    b = (argb & 0xFF) - g
    return (
        (argb & 0xFF00FF00)
        | ((r & 0xFF) << 16)
        | (b & 0xFF)
    ).astype(np.uint32)


def _delta(t_u8: np.ndarray, c_u8: np.ndarray) -> np.ndarray:
    """ColorTransformDelta: (int8(t) * int8(c)) >> 5 (arithmetic shift)."""
    t = t_u8.astype(np.int8).astype(np.int32)
    c = c_u8.astype(np.int8).astype(np.int32)
    return (t * c) >> 5


def color_transform_forward(
    argb: np.ndarray, transform_img: np.ndarray, bits: int
) -> np.ndarray:
    """The encoder's cross-colour transform with the tile multipliers of
    ``transform_img`` (the inverse's layout)."""
    h, w = argb.shape
    ty = np.arange(h) >> bits
    tx = np.arange(w) >> bits
    tiles = transform_img[np.ix_(ty, tx)]
    g2r = tiles & 0xFF
    g2b = (tiles >> 8) & 0xFF
    r2b = (tiles >> 16) & 0xFF

    g = (argb >> 8) & 0xFF
    r = (argb >> 16) & 0xFF
    b = argb & 0xFF
    new_r = (r - _delta(g2r, g)) & 0xFF
    # red_to_blue applies to the ORIGINAL red (the decoder restores red
    # before using it in the blue inverse).
    new_b = (b - _delta(g2b, g) - _delta(r2b, r)) & 0xFF
    return (
        (argb & 0xFF00FF00) | (new_r.astype(np.uint32) << 16)
        | new_b.astype(np.uint32)
    ).astype(np.uint32)


def color_transform_inverse(
    argb: np.ndarray, transform_img: np.ndarray, bits: int
) -> np.ndarray:
    """argb: (H, W) uint32; transform_img: (tH, tW) uint32 tile multipliers
    (green_to_red in the low byte, green_to_blue, red_to_blue above)."""
    h, w = argb.shape
    buf = np.ascontiguousarray(argb, np.uint32).copy()
    timg = np.ascontiguousarray(transform_img, np.uint32)
    get_lib().wtpu_vp8l_color_inverse(_u32(buf), w, h, _u32(timg), bits,
                                      transform_img.shape[1])
    return buf


def color_index_inverse(
    packed: np.ndarray, palette: np.ndarray, width: int
) -> np.ndarray:
    """Unpack bundled indices and map through the palette.

    packed: (H, packedW) uint32 where the green channel holds bundled
    indices; palette: (n,) uint32 ARGB entries; returns (H, width) uint32.
    """
    n = len(palette)
    xbits = 0 if n > 16 else (1 if n > 4 else (2 if n > 2 else 3))
    h = packed.shape[0]
    green = (packed >> 8) & 0xFF
    if xbits == 0:
        idx = green[:, :width]
    else:
        per = 1 << xbits            # pixels bundled per packed pixel
        bw = 8 >> xbits             # bits per index
        mask = (1 << bw) - 1
        shifts = (np.arange(per) * bw)[None, None, :]
        expanded = (green[:, :, None] >> shifts) & mask   # (H, packedW, per)
        idx = expanded.reshape(h, -1)[:, :width]
    # Out-of-range indices decode as transparent black.
    safe_palette = np.zeros(256, dtype=np.uint32)
    safe_palette[:n] = palette
    return safe_palette[idx]


def predictor_inverse(
    residuals: np.ndarray, predictor_img: np.ndarray, bits: int
) -> np.ndarray:
    """Raster-order inverse of the predictor transform.

    residuals: (H, W) uint32; predictor_img: (tH, tW) uint32 whose green
    channel holds the tile's mode.  TR of the last column wraps to the
    current row's first pixel (contiguous-memory semantics the format
    relies on).
    """
    h, w = residuals.shape
    buf = np.ascontiguousarray(residuals, np.uint32).copy()
    modes = np.ascontiguousarray(predictor_img.reshape(-1), np.uint32)
    get_lib().wtpu_vp8l_predictor_inverse(_u32(buf), w, h, _u32(modes), bits,
                                          predictor_img.shape[1])
    return buf


__all__ = [
    "add_green_inverse",
    "color_index_inverse",
    "color_transform_forward",
    "color_transform_inverse",
    "predictor_inverse",
    "subsample_size",
    "subtract_green_forward",
]
