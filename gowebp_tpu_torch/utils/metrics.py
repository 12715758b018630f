"""Distortion metric of the encoder's statistics: PSNR."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    """PSNR in dB of two same-shaped arrays (99.0 when they are equal)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return 99.0
    return float(10.0 * np.log10(max_value * max_value / mse))


__all__ = ["psnr"]
