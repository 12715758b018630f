"""Distortion metrics on the host: PSNR (the encoder's statistics use it),
per-channel PSNR and SSIM."""

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


def plane_psnr(a: np.ndarray, b: np.ndarray) -> dict:
    """PSNR of each channel ("r", "g", "b", "a") and of all of them
    ("all") for (H, W, C) images."""
    out = {}
    names = ["r", "g", "b", "a"]
    for c in range(min(a.shape[-1], 4)):
        out[names[c]] = psnr(a[..., c], b[..., c])
    out["all"] = psnr(a, b)
    return out


def ssim(a: np.ndarray, b: np.ndarray, *, window: int = 8) -> float:
    """Mean SSIM over non-overlapping ``window`` squares of one plane (an
    (H, W, C) image is taken as its Rec. 601 luma).  An image smaller than
    a window gives 1.0 when equal, else 0.0."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        b = 0.299 * b[..., 0] + 0.587 * b[..., 1] + 0.114 * b[..., 2]
    h, w = a.shape
    hh = h - h % window
    ww = w - w % window
    if hh == 0 or ww == 0:
        return 1.0 if np.array_equal(a, b) else 0.0
    aw = a[:hh, :ww].reshape(hh // window, window, ww // window, window)
    bw = b[:hh, :ww].reshape(hh // window, window, ww // window, window)
    mu_a = aw.mean(axis=(1, 3))
    mu_b = bw.mean(axis=(1, 3))
    var_a = aw.var(axis=(1, 3))
    var_b = bw.var(axis=(1, 3))
    cov = (aw * bw).mean(axis=(1, 3)) - mu_a * mu_b
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


__all__ = ["plane_psnr", "psnr", "ssim"]
