"""The RIFF container of a still WebP file and its ALPH chunk, written from
the WebP container specification (RFC 9649 section 2) as the benchmark's
reference; it shares no code with the program.

A still file is a simple lossy file (``VP8 ``), an extended one (``VP8X``,
then chunks in any order, of which ``ALPH`` and ``VP8 `` are read and
ICC, EXIF, XMP and unknown chunks skipped), or a lossless one (``VP8L``).
Animations (``ANIM``/``ANMF``) are outside this reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitstream import StreamError


@dataclass
class Still:
    kind: str                   # "vp8" or "vp8l"
    payload: bytes              # the VP8 or VP8L chunk's body
    alpha: bytes | None = None  # the ALPH chunk's body, with its header byte


def read_still(data: bytes) -> Still:
    """The image chunks of a still WebP file."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise StreamError("not a RIFF WEBP file")
    pos, alpha, extended = 12, None, False
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        body = data[pos + 8:pos + 8 + size]
        if len(body) != size:
            raise StreamError(f"truncated {tag!r} chunk")
        if tag in (b"ANIM", b"ANMF"):
            raise StreamError(f"chunk {tag!r} is outside this reference")
        if tag == b"VP8X" and pos == 12:
            extended = True
        elif tag == b"ALPH" and extended and alpha is None:
            alpha = body
        elif tag == b"VP8 ":
            return Still("vp8", body, alpha)
        elif tag == b"VP8L":
            return Still("vp8l", body)
        pos += 8 + size + (size & 1)
    raise StreamError("no VP8 or VP8L chunk")


def _waves(out: np.ndarray) -> None:
    """The gradient filter's inverse on rows and columns 1.. of ``out``
    (residuals there, row 0 and column 0 done), one anti-diagonal
    x + y = t at a time: a pixel needs its left, top and top-left."""
    h, w = out.shape
    for t in range(2, (h - 1) + (w - 1) + 1):
        ys = np.arange(max(1, t - w + 1), min(h - 1, t - 1) + 1)
        xs = t - ys
        left, top, tl = out[ys, xs - 1], out[ys - 1, xs], out[ys - 1, xs - 1]
        out[ys, xs] = (out[ys, xs] + np.clip(left + top - tl, 0, 255)) & 255


def unfilter(method: int, plane: np.ndarray) -> np.ndarray:
    """Invert an ALPH spatial filter: 0 none, 1 horizontal, 2 vertical,
    3 gradient.  Row 0 is predicted from the left (its first pixel from
    0), column 0 from above, other pixels by the filter."""
    if method == 0:
        return plane
    out = plane.astype(np.int64)
    if method == 1:
        out[:, 0] = np.cumsum(out[:, 0])
        out = np.cumsum(out, axis=1)
    elif method == 2:
        out[0] = np.cumsum(out[0])
        out = np.cumsum(out, axis=0)
    else:
        out[0] = np.cumsum(out[0])
        out[:, 0] = np.cumsum(out[:, 0])
        out &= 255
        _waves(out)
    return (out & 255).astype(np.uint8)


def decode_alpha(payload: bytes, width: int, height: int) -> np.ndarray:
    """(height, width) uint8 alpha plane of an ALPH chunk.  Its
    pre-processing bits are read and left alone: with no alpha dithering,
    libwebp's default, the decoder does not smooth quantized levels."""
    if not payload:
        raise StreamError("empty ALPH chunk")
    hdr = payload[0]
    method, filt, pre, rsrv = hdr & 3, (hdr >> 2) & 3, (hdr >> 4) & 3, hdr >> 6
    if method > 1 or pre > 1 or rsrv:
        raise StreamError(f"ALPH header {hdr:#04x}")
    data = payload[1:]
    if method == 0:
        if len(data) < width * height:
            raise StreamError("raw ALPH data too short")
        plane = np.frombuffer(data, np.uint8, width * height).reshape(
            height, width)
    else:
        from .lossless import decode_alpha_stream

        plane = decode_alpha_stream(data, width, height)
    return unfilter(filt, plane)
