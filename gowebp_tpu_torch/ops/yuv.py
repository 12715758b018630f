"""Batched chroma upsampling + YUV→RGBA in PyTorch — exact integer math.

The decode's post-processing: libwebp's "fancy" 2x chroma upsampler
(each output pixel weighs its four nearest chroma samples 9:3:3:1), or
nearest upsampling (``no_fancy_upsampling``), and the BT.601 fixed-point
YUV→RGB conversion.  ``batch_yuv_to_rgba`` is
the plain version of the yuv420_to_rgba kernel (ops/kernels/).
"""

from __future__ import annotations

import torch

I32 = torch.int32
YUV_MASK2 = (256 << 6) - 1


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def yuv_to_rgb(y, u, v):
    """(..., H, W) int planes → (..., H, W, 3) uint8 RGB."""
    y, u, v = (p.to(I32) for p in (y, u, v))
    yy = _mult_hi(y, 19077)

    def clip8(x):
        return (torch.clamp(x, 0, YUV_MASK2) >> 6).to(torch.uint8)

    r = clip8(yy + _mult_hi(v, 26149) - 14234)
    g = clip8(yy - _mult_hi(u, 6419) - _mult_hi(v, 13320) + 8708)
    b = clip8(yy + _mult_hi(u, 33050) - 17685)
    return torch.stack([r, g, b], dim=-1)


def _pair_rows(T, B, width: int):
    """Full-width interpolation between chroma rows T, B (..., w2) →
    (top, bot) (..., width): the output rows nearer T and nearer B."""
    w2 = T.shape[-1]
    top = torch.zeros(T.shape[:-1] + (width,), dtype=I32, device=T.device)
    bot = torch.zeros_like(top)
    top[..., 0] = (3 * T[..., 0] + B[..., 0] + 2) >> 2
    bot[..., 0] = (3 * B[..., 0] + T[..., 0] + 2) >> 2
    if w2 > 1:
        tl, t, l, c = T[..., :-1], T[..., 1:], B[..., :-1], B[..., 1:]
        avg = tl + t + l + c + 8
        d12 = (avg + 2 * (t + l)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        n = w2 - 1
        top[..., 1:2 * n:2] = (d12 + tl) >> 1
        top[..., 2:2 * n + 2:2] = (d03 + t) >> 1
        bot[..., 1:2 * n:2] = (d03 + l) >> 1
        bot[..., 2:2 * n + 2:2] = (d12 + c) >> 1
    if width % 2 == 0 and width > 1:
        top[..., width - 1] = (3 * T[..., w2 - 1] + B[..., w2 - 1] + 2) >> 2
        bot[..., width - 1] = (3 * B[..., w2 - 1] + T[..., w2 - 1] + 2) >> 2
    return top, bot


def fancy_upsample(chroma, height: int, width: int):
    """(..., H2, W2) chroma → (..., height, width) uint8, libwebp-exact.

    Row 0 pairs chroma row 0 with itself, rows 2j+1 and 2j+2 are the
    T-near and B-near halves of the pair (j, j+1), and an even height's
    last row pairs the last chroma row with itself.
    """
    ch = chroma.to(I32)
    h2 = ch.shape[-2]
    out = torch.zeros(ch.shape[:-2] + (height, width), dtype=I32,
                      device=ch.device)
    out[..., 0, :] = _pair_rows(ch[..., 0, :], ch[..., 0, :], width)[0]
    if h2 > 1:
        tops, bots = _pair_rows(ch[..., :-1, :], ch[..., 1:, :], width)
        out[..., 1:2 * h2 - 2:2, :] = tops
        out[..., 2:2 * h2 - 1:2, :] = bots
    if height % 2 == 0 and height > 1:
        last = ch[..., h2 - 1, :]
        out[..., height - 1, :] = _pair_rows(last, last, width)[0]
    return out.to(torch.uint8)


def simple_upsample(chroma, height: int, width: int):
    """(..., H2, W2) chroma → (..., height, width): nearest upsampling,
    each sample repeated over its 2x2 pixels."""
    up = chroma.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up[..., :height, :width].to(torch.uint8)


def batch_yuv_to_rgba(y, u, v, alpha=None, fancy: bool = True):
    """(B, H, W) luma + (B, ⌈H/2⌉, ⌈W/2⌉) chroma [+ (B, H, W) alpha] →
    (B, H, W, 4) uint8 RGBA; alpha 255 when none is given.  ``fancy``
    False upsamples the chroma by nearest samples."""
    B, H, W = y.shape
    up = fancy_upsample if fancy else simple_upsample
    rgb = yuv_to_rgb(y, up(u, H, W), up(v, H, W))
    if alpha is None:
        a = torch.full((B, H, W, 1), 255, dtype=torch.uint8, device=y.device)
    else:
        a = alpha.to(torch.uint8)[..., None]
    return torch.cat([rgb, a], dim=-1)


__all__ = ["batch_yuv_to_rgba", "fancy_upsample", "simple_upsample",
           "yuv_to_rgb"]
