"""Open-loop dense encode: the engine of encode_rgba_batch(engine="openloop").

Prediction context comes from the source planes instead of the
reconstruction, so no macroblock waits for another: every MB of every
image is searched, transformed and quantized at once.  That makes it
the fastest engine, at a lower quality than the hybrid's (prediction
drift: the decoder predicts from its reconstruction, not the source).

``encode_plane_core_v2`` runs the luma kernel (i16 DC/TM/VE/HE search,
residual FDCT, Y1 quantization, and the Y2 path: the WHT of each MB's 16
DCs, quantized with bias 96 << 9 for DC and AC), then the chroma kernel
(joint U+V search, FDCT, quantization): ops/kernels/encode_plane.py,
which runs the kernels on CUDA tensors and their plain versions on CPU
tensors.  All arithmetic is exact int32.
"""

from __future__ import annotations

import torch

from .dct import BIAS
from .kernels.encode_plane import encode_chroma, encode_luma


def _iq(q: int) -> int:
    return (1 << 17) // int(q)


def encode_plane_core_v2(y, u, v, *, y1_dc, y1_ac, y2_dc, y2_ac, uv_dc,
                         uv_ac, y_halo=None, u_halo=None, v_halo=None,
                         leftmost=None, marks=None):
    """Open-loop encode of MB-padded planes with one quantizer set.

    y (B, 16*mh, 16*mw), u/v (B, 8*mh, 8*mw) holding 0..255 (uint8, or
    any integer type); y1_dc..uv_ac the six quantizer steps.  Returns
    ymode/uvmode (B, mh, mw) uint8 and the zigzag int16 levels y_levels
    (B, mh, mw, 16, 16), y2_levels (B, mh, mw, 16) and uv_levels
    (B, mh, mw, 8, 16), U blocks 0-3 then V blocks 4-7.  ``marks``, if
    given, is called with "luma" and "chroma" after each is enqueued.

    A width tile of planes split over devices passes its left
    neighbour's last columns, y_halo (B, 16*mh) and u_halo/v_halo
    (B, 8*mh), and ``leftmost`` False: its MB column 0 predicts from
    them (the kernels' halo forms).  The leftmost tile (``leftmost``
    true, or no halo) keeps the frame's left edge fill.
    """
    mark = marks if marks is not None else (lambda name: None)
    U8 = torch.uint8
    halo = y_halo is not None and not bool(leftmost)

    def col(t):
        return t.to(U8).contiguous() if halo else None

    ymode, y_levels, y2_levels = encode_luma(
        y.to(U8), (_iq(y1_dc), BIAS["y1_dc"], _iq(y1_ac), BIAS["y1_ac"]),
        (_iq(y2_dc), BIAS["y2_dc"], _iq(y2_ac), BIAS["y2_ac"]),
        halo=col(y_halo))
    mark("luma")
    uvmode, uv_levels = encode_chroma(
        u.to(U8), v.to(U8),
        (_iq(uv_dc), BIAS["uv_dc"], _iq(uv_ac), BIAS["uv_ac"]),
        halo=(col(u_halo), col(v_halo)) if halo else None)
    mark("chroma")
    return {"ymode": ymode, "uvmode": uvmode, "y_levels": y_levels,
            "y2_levels": y2_levels, "uv_levels": uv_levels}


__all__ = ["encode_plane_core_v2"]
