"""Level quantization of the alpha plane (alpha_quality < 100)."""

from __future__ import annotations

import numpy as np


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


__all__ = ["quantize_alpha_levels"]
