"""Colour conversion of the reference: the encoder's RGB -> YUV 4:2:0
(libwebp's ImportYUVAFromRGBA without gamma, a 2x2 sum per chroma sample)
and the decoder's YUV 4:2:0 -> RGBA (libwebp's fancy upsampler and its
14-bit BT.601 conversion)."""

from __future__ import annotations

import numpy as np

I64 = np.int64
FIX = 16
HALF = 1 << (FIX - 1)


def rgb_to_yuv420(rgb):
    """(H, W, 3+) uint8 -> Y (H, W), U, V ((H+1)//2, (W+1)//2), int64."""
    a = np.asarray(rgb)[..., :3].astype(I64)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + HALF + (16 << FIX)) >> FIX
    h, w = r.shape
    pad = ((0, h & 1), (0, w & 1))

    def sum4(c):
        c = np.pad(c, pad, mode="edge")
        return c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]

    rs, gs, bs = sum4(r), sum4(g), sum4(b)
    rnd = (HALF << 2) + (128 << (FIX + 2))
    u = np.clip((-9719 * rs - 19081 * gs + 28800 * bs + rnd) >> (FIX + 2),
                0, 255)
    v = np.clip((28800 * rs - 24116 * gs - 4684 * bs + rnd) >> (FIX + 2),
                0, 255)
    return y, u, v


def _upsample(c, h, w):
    """Fancy (bilinear, 9-3-3-1) upsampling of a chroma plane to h x w."""
    c = c.astype(I64)
    ch = c.shape[0]
    ys = np.arange(h)
    # the nearer chroma row (weight 3) and the farther one (weight 1)
    near = np.where(ys == 0, 0, np.where(ys & 1, (ys - 1) >> 1, ys >> 1))
    far = np.where(ys == 0, 0, np.where(ys & 1, (ys + 1) >> 1, (ys >> 1) - 1))
    near, far = np.minimum(near, ch - 1), np.minimum(far, ch - 1)
    N, F = c[near], c[far]                              # (h, cw)
    out = np.empty((h, w), I64)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        n0, n1 = N[:, :pairs], N[:, 1:pairs + 1]
        f0, f1 = F[:, :pairs], F[:, 1:pairs + 1]
        s = n0 + n1 + f0 + f1 + 8
        out[:, 1:2 * pairs:2] = (((s + 2 * (n1 + f0)) >> 3) + n0) >> 1
        out[:, 2:2 * pairs + 1:2] = (((s + 2 * (n0 + f1)) >> 3) + n1) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * N[:, pairs] + F[:, pairs] + 2) >> 2
    return out


def _clip8(v):
    return np.clip(v >> 6, 0, 255)


def yuv420_to_rgba(y, u, v, width, height, fancy=True):
    """Cropped (height, width, 4) uint8 RGBA of MB-aligned planes."""
    y = y[:height, :width].astype(I64)
    cw, chh = (width + 1) >> 1, (height + 1) >> 1
    u, v = u[:chh, :cw], v[:chh, :cw]
    if fancy:
        uu, vv = _upsample(u, height, width), _upsample(v, height, width)
    else:
        uu = np.repeat(np.repeat(u, 2, 0), 2, 1)[:height, :width].astype(I64)
        vv = np.repeat(np.repeat(v, 2, 0), 2, 1)[:height, :width].astype(I64)
    yy = (y * 19077) >> 8
    out = np.empty((height, width, 4), np.uint8)
    out[..., 0] = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    out[..., 1] = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    out[..., 2] = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    out[..., 3] = 255
    return out
