"""Deterministic natural-statistics image generator (seeded NumPy).

A frozen copy of ``gowebp_tpu_torch/utils/corpus.py``: a dead-leaves
occlusion model with power-law sizes, 1/f spectral texture, correlated
channels and a smooth illumination field (the statistics codecs key on),
with no files to vendor.  The benchmark makes every input image with it,
so a change to the program's copy changes no cell.
"""

from __future__ import annotations

import numpy as np


def _dead_leaves(h: int, w: int, rng: np.random.Generator,
                 n_leaves: int = 220) -> np.ndarray:
    """Opaque-ellipse dead-leaves luminance+chroma base, float (h, w, 3).

    Sizes follow a 1/r^3 density between rmin and rmax (scale-invariant
    regime), drawn back-to-front so later leaves occlude earlier ones.
    """
    img = np.empty((h, w, 3), np.float32)
    img[...] = rng.uniform(60, 196, 3).astype(np.float32)
    rmin, rmax = 0.015 * min(h, w), 0.45 * min(h, w)
    # inverse-CDF sampling of p(r) ~ r^-3
    u = rng.random(n_leaves)
    radii = 1.0 / np.sqrt(u / rmin**2 + (1 - u) / rmax**2)
    cx = rng.uniform(0, w, n_leaves)
    cy = rng.uniform(0, h, n_leaves)
    aspect = rng.uniform(0.4, 1.0, n_leaves)
    theta = rng.uniform(0, np.pi, n_leaves)
    # correlated colors: shared luminance + small chroma spread
    luma = rng.uniform(35, 225, n_leaves)
    col = luma[:, None] + rng.normal(0, 14, (n_leaves, 3))
    yy_full, xx_full = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n_leaves):
        r = radii[i]
        x0 = max(int(cx[i] - r - 1), 0)
        x1 = min(int(cx[i] + r + 2), w)
        y0 = max(int(cy[i] - r - 1), 0)
        y1 = min(int(cy[i] + r + 2), h)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = xx_full[y0:y1, x0:x1] - cx[i]
        dy = yy_full[y0:y1, x0:x1] - cy[i]
        c, s = np.cos(theta[i]), np.sin(theta[i])
        ex = (c * dx + s * dy) / r
        ey = (-s * dx + c * dy) / (r * aspect[i])
        mask = ex * ex + ey * ey <= 1.0
        img[y0:y1, x0:x1][mask] = col[i]
    return img


def _spectral_noise(h: int, w: int, rng: np.random.Generator,
                    alpha: float = 1.15) -> np.ndarray:
    """1/f^alpha random-phase noise, unit std, float (h, w)."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** (-alpha)
    amp[0, 0] = 0.0
    phase = rng.random((h, amp.shape[1])) * 2 * np.pi
    spec = amp * np.exp(1j * phase)
    x = np.fft.irfft2(spec, s=(h, w))
    sd = x.std()
    return (x / sd if sd > 0 else x).astype(np.float32)


def natural_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """One deterministic photographic-statistics RGB uint8 image."""
    rng = np.random.default_rng(np.random.SeedSequence([1724, seed]))
    img = _dead_leaves(h, w, rng)
    # shared-luminance multi-scale texture + small decorrelated residue
    tex = _spectral_noise(h, w, rng)
    img += 18.0 * tex[..., None]
    for ch in range(3):
        img[..., ch] += 6.0 * _spectral_noise(h, w, rng)
    # smooth illumination field (low-order gradient, multiplicative)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gdir = rng.uniform(0, 2 * np.pi)
    g = (xx / w) * np.cos(gdir) + (yy / h) * np.sin(gdir)
    img *= (0.82 + 0.36 * (g - g.min()) / max(float(np.ptp(g)), 1e-6))[..., None]
    # sensor noise
    img += rng.normal(0, 2.0, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def natural_images(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 batch of distinct deterministic images.

    Generated on a small thread pool (the FFT/raster work releases the
    GIL); output is independent of thread scheduling.
    """
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(4, max(1, n))) as ex:
        return np.stack(list(ex.map(
            lambda i: natural_image(h, w, seed=seed * 1000 + i),
            range(n))))


__all__ = ["natural_image", "natural_images"]
