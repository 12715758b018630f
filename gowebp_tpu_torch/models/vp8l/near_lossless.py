"""Near-lossless preprocessing for VP8L, and the level quantization of
the alpha plane (alpha_quality < 100).

Near-lossless discretizes pixel channels to a coarser grid where the
surrounding texture hides the error, leaving smooth-gradient regions
exact (so no banding): libwebp's max-diff driven per-pixel
quantization.
"""

from __future__ import annotations

import numpy as np


def near_lossless_bits(quality: int) -> int:
    """100→0, 80..99→1, 60..79→2, 40..59→3, 20..39→4, 0..19→5."""
    return 5 - quality // 20


def _max_neighbor_diff(ch: np.ndarray) -> np.ndarray:
    """Per-pixel max |diff| to the 4-neighborhood (edge-replicated)."""
    p = np.pad(ch.astype(np.int32), 1, mode="edge")
    c = p[1:-1, 1:-1]
    diffs = np.stack([
        np.abs(c - p[:-2, 1:-1]),
        np.abs(c - p[2:, 1:-1]),
        np.abs(c - p[1:-1, :-2]),
        np.abs(c - p[1:-1, 2:]),
    ])
    return diffs.max(axis=0)


def apply_near_lossless(rgba: np.ndarray, quality: int) -> np.ndarray:
    """(H, W, 4) uint8 → preprocessed copy (quality 100 = unchanged)."""
    bits = near_lossless_bits(quality)
    if bits == 0:
        return rgba
    step = 1 << bits
    half = step >> 1
    out = rgba.astype(np.int32).copy()
    for c in range(4):
        ch = out[..., c]
        maxdiff = _max_neighbor_diff(rgba[..., c])
        # Busy areas (local contrast above the step) absorb the error;
        # smooth areas stay exact to avoid banding.
        busy = maxdiff >= step
        disc = np.minimum((ch + half) & ~(step - 1), 255)
        out[..., c] = np.where(busy, disc, ch)
    return out.astype(np.uint8)


def quantize_alpha_levels(plane: np.ndarray, quality: int) -> np.ndarray:
    """Reduce the alpha plane to fewer levels (alpha_quality < 100).

    Uniform mid-rise quantization over the plane's actual range: the
    simple form of libwebp's quant_levels Lloyd pass.
    """
    if quality >= 100:
        return plane
    num_levels = max(2, 2 + quality * 14 // 100)
    lo = int(plane.min())
    hi = int(plane.max())
    if hi <= lo:
        return plane
    span = hi - lo
    idx = ((plane.astype(np.int32) - lo) * (num_levels - 1) + span // 2) // span
    return (lo + idx * span // (num_levels - 1)).astype(np.uint8)


__all__ = ["apply_near_lossless", "near_lossless_bits",
           "quantize_alpha_levels"]
