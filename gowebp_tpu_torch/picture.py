"""Encoder-side picture utilities: view / crop / rescale.

libwebp's WebPPictureView, WebPPictureCrop and WebPPictureRescale for
the array API: pictures are (H, W, 3|4) uint8 arrays, so a view is a
zero-copy NumPy slice and a crop is that slice copied, both on the host.

``picture_rescale`` runs on a device: the decode's fixed-point
rescaler (decode_options.py ``_rescale``, int64 torch ops), with an
alpha-bearing picture premultiplied before the scaler and
un-premultiplied after (libwebp's WebPMultARGBRows around its rescaler,
so that transparent pixels do not bleed colour into their neighbours),
in 8-bit fixed point on the same device.  The result comes back as a
NumPy array.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode_options import _rescale
from .device import resolve_device
from .errors import WebPError


def _check_rect(shape, left: int, top: int, width: int, height: int) -> None:
    h, w = shape[:2]
    if width <= 0 or height <= 0:
        raise WebPError(f"bad crop size {width}x{height}")
    if left < 0 or top < 0 or left + width > w or top + height > h:
        raise WebPError(
            f"crop rect {left},{top} {width}x{height} outside {w}x{h}")


def picture_view(rgba: np.ndarray, left: int, top: int,
                 width: int, height: int) -> np.ndarray:
    """Zero-copy sub-rectangle view (WebPPictureView).

    The returned array shares memory with the input: mutating either
    affects both, like libwebp's borrowed-memory view.
    """
    rgba = np.asarray(rgba)
    _check_rect(rgba.shape, left, top, width, height)
    return rgba[top:top + height, left:left + width]


def picture_crop(rgba: np.ndarray, left: int, top: int,
                 width: int, height: int) -> np.ndarray:
    """Owned sub-rectangle copy (WebPPictureCrop)."""
    return np.ascontiguousarray(picture_view(rgba, left, top, width, height))


def _mult(c, a):
    """8-bit premultiply, (c * a * 32897) >> 23."""
    return ((c.to(torch.int64) * a.to(torch.int64) * 32897) >> 23
            ).to(torch.uint8)


def _unmult(c, a):
    """8-bit un-premultiply, min(round(c * 255 / a), 255); 0 where a is 0."""
    a64 = a.to(torch.int64).clamp_min(1)
    out = ((c.to(torch.int64) * 255 + a64 // 2) // a64).clamp_max(255)
    return torch.where(a == 0, 0, out).to(torch.uint8)


def picture_rescale(rgba: np.ndarray, width: int = 0, height: int = 0, *,
                    device=None) -> np.ndarray:
    """Fixed-point rescale (WebPPictureRescale) on ``device``.

    Passing 0 for one dimension preserves the aspect ratio.  Alpha-bearing
    inputs are premultiplied around the scaler.  ``device`` None means
    CUDA and raises without it; ``device="cpu"`` runs on the host (the
    same pixels).
    """
    dev = resolve_device(device)
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise WebPError("picture must be (H, W, 3|4) uint8")
    h, w = rgba.shape[:2]
    if width == 0 and height == 0:
        raise WebPError("rescale needs a target width or height")
    if width == 0:
        width = max(1, (w * height + h - 1) // h)
    if height == 0:
        height = max(1, (h * width + w - 1) // w)
    if (width, height) == (w, h):
        return rgba.copy()
    img = torch.from_numpy(np.ascontiguousarray(rgba)).to(dev)
    if rgba.shape[2] == 4 and bool((img[..., 3] != 255).any()):
        a = img[..., 3:]
        scaled = _rescale(torch.cat([_mult(img[..., :3], a), a], -1), width,
                          height)
        sa = scaled[..., 3:]
        scaled = torch.cat([_unmult(scaled[..., :3], sa), sa], -1)
    else:
        scaled = _rescale(img, width, height)
    return scaled.cpu().numpy()


__all__ = ["picture_crop", "picture_rescale", "picture_view"]
