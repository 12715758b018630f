"""The benchmark's plain reference for WebP: a still-file decoder (VP8 with
its ALPH plane, and VP8L) and a re-derivation of the levels a closed-loop
VP8 encoder codes, in NumPy.  It imports nothing of the program."""

from __future__ import annotations

from .bitstream import Frame, StreamError, parse, parse_frame
from .color import rgb_to_yuv420, yuv420_to_rgba
from .container import decode_alpha, read_still
from .lossless import decode_vp8l
from .recon import LevelCheck, dequantize, loop_filter, reconstruct


def decode_rgba(data: bytes, *, loop_filter_on: bool = True,
                fancy: bool = True, predictor_on: bool = True,
                work: dict | None = None):
    """(H, W, 4) uint8 RGBA of a still WebP file, as libwebp decodes it by
    default: a VP8 frame's RGB with its ALPH plane as alpha (255 without
    one), or a VP8L image.  ``loop_filter_on=False`` or ``fancy=False``
    give a VP8 frame's decode without the loop filter or with nearest
    upsampling, ``predictor_on=False`` a VP8L image's without the inverse
    predictor transform.  ``work`` (a dict) gains what a VP8 frame's decode
    had to do: macroblocks ("mb"), of them i4 ones ("i4"), 4x4 blocks with
    only a DC coefficient ("blocks_dc") and with an AC one ("blocks_ac"),
    and the loop filter's lines by kind of edge ("filter", as
    ``loop_filter`` counts them); a VP8L file adds nothing to it."""
    still = read_still(data)
    if still.kind == "vp8l":
        return decode_vp8l(still.payload, predictor=predictor_on)
    fr = parse_frame(still.payload)
    y, u, v, nz = reconstruct(fr)
    if work is not None:
        coef = dequantize(fr)                   # (mb_h, mb_w, 24, 16)
        ac = (coef[..., 1:] != 0).any(-1)
        dc = (coef[..., 0] != 0) & ~ac
        work.update(mb=fr.mb_w * fr.mb_h, i4=int(fr.is_i4.sum()),
                    blocks_dc=int(dc.sum()), blocks_ac=int(ac.sum()),
                    filter={})
    if loop_filter_on:
        loop_filter(fr, y, u, v, nz,
                    None if work is None else work["filter"])
    rgba = yuv420_to_rgba(y, u, v, fr.width, fr.height, fancy=fancy)
    if still.alpha is not None:
        rgba[..., 3] = decode_alpha(still.alpha, fr.width, fr.height)
    return rgba


def check_levels(data: bytes, rgb, *, diffusion: bool):
    """(frame, blocks whose coded levels differ from the closed-loop
    encoder's on the source ``rgb``, blocks compared)."""
    fr = parse(data)
    ys, us, vs = rgb_to_yuv420(rgb)
    chk = LevelCheck(ys, us, vs, diffusion)
    reconstruct(fr, chk)
    return fr, chk.bad, chk.blocks


__all__ = ["Frame", "StreamError", "parse", "read_still", "decode_rgba",
           "check_levels"]
