"""Alpha planes of RGBA source images, made from a seed, one model a name.
A configuration names its model as ``image.alpha``; the generator lays the
plane over the RGB of ``corpus.natural_image``, so the RGB under the
transparent area is real content.  Imports nothing of the program.

``cutout``: a product cut-out or sticker.  An opaque object, a seeded union
of dead-leaves ellipses covering 35-65% of the frame, with an anti-aliased
edge 1-3 px wide; a soft drop shadow of the object at partial alpha; alpha 0
everywhere else.
"""

from __future__ import annotations

import numpy as np

SHADOW_MARGIN = 32      # px past an ellipse's box that its shadow reaches


def _ellipses(rng, n: int, h: int, w: int) -> np.ndarray:
    """(n, 5) centres (y, x), semi-axes (a, b) for a unit scale, angles."""
    s = min(h, w)
    cy = h / 2 + rng.uniform(-0.15, 0.15, n) * h
    cx = w / 2 + rng.uniform(-0.15, 0.15, n) * w
    a = rng.uniform(0.12, 0.3, n) * s
    b = a * rng.uniform(0.45, 1.0, n)
    return np.stack([cy, cx, a, b, rng.uniform(0, np.pi, n)], axis=1)


def _distance(ell: np.ndarray, scale: float, ys: np.ndarray, xs: np.ndarray,
              margin: float) -> np.ndarray:
    """Approximate signed distance in px from the points (ys x xs grid) to
    the union of the scaled ellipses: f / |grad f| of each ellipse's
    implicit f, the least over ellipses; +inf past ``margin`` outside."""
    d = np.full((len(ys), len(xs)), np.inf, np.float32)
    for cy, cx, a, b, th in ell:
        a, b = a * scale, b * scale
        c, s = np.cos(th), np.sin(th)
        ry = np.sqrt((a * s) ** 2 + (b * c) ** 2) + margin
        rx = np.sqrt((a * c) ** 2 + (b * s) ** 2) + margin
        y0, y1 = np.searchsorted(ys, [cy - ry, cy + ry])
        x0, x1 = np.searchsorted(xs, [cx - rx, cx + rx])
        if y0 >= y1 or x0 >= x1:
            continue
        dy = ys[y0:y1, None] - cy
        dx = xs[None, x0:x1] - cx
        u = (c * dx + s * dy) / a
        v = (-s * dx + c * dy) / b
        f = u * u + v * v - 1.0
        g = 2.0 * np.sqrt((u / a) ** 2 + (v / b) ** 2)
        with np.errstate(divide="ignore"):
            de = np.where(g > 0, f / np.maximum(g, 1e-12), -np.inf)
        np.minimum(d[y0:y1, x0:x1], de.astype(np.float32),
                   out=d[y0:y1, x0:x1])
    return d


def cutout(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w) uint8 alpha plane of a cut-out."""
    rng = np.random.default_rng(np.random.SeedSequence([7411, seed]))
    ell = _ellipses(rng, int(rng.integers(3, 8)), h, w)
    want = rng.uniform(0.4, 0.6)                # of the frame, opaque
    edge = rng.uniform(1.0, 3.0)                # px of anti-aliased edge
    # the scale at which the union covers ``want``, on a coarse grid
    k = max(1, min(h, w) // 128)
    ys, xs = np.arange(k / 2, h, k), np.arange(k / 2, w, k)
    lo, hi = 0.2, 3.0
    for _ in range(20):
        mid = (lo + hi) / 2
        if (_distance(ell, mid, ys, xs, 0.0) < 0).mean() < want:
            lo = mid
        else:
            hi = mid
    ys, xs = np.arange(h) + 0.5, np.arange(w) + 0.5
    d = _distance(ell, lo, ys, xs, SHADOW_MARGIN)
    obj = np.clip(0.5 - d / edge, 0.0, 1.0)
    # the shadow: the object moved down and aside, its edge blurred
    oy = int(rng.integers(2, 6)) * max(1, min(h, w) // 256)
    ox = int(rng.integers(-5, 6)) * max(1, min(h, w) // 256)
    blur = rng.uniform(8.0, 24.0)
    peak = rng.uniform(0.3, 0.6)
    ds = _distance(ell, lo, ys - oy, xs - ox, SHADOW_MARGIN)
    sh = peak * np.clip(0.5 - ds / blur, 0.0, 1.0)
    a = obj + sh * (1.0 - obj)
    return np.rint(255.0 * a).astype(np.uint8)


# name -> f(h, w, seed): (h, w) uint8 alpha plane
MODELS = {"cutout": cutout}
