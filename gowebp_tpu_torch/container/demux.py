"""Demuxer: split a WebP container into its frames and metadata chunks.

``demux`` reads a simple or an extended file: the VP8X features, the ANIM
loop count and background colour, each ANMF frame's placement, timing,
dispose and blend flags and image payloads, a still file's one frame,
the ICCP, EXIF and XMP payloads and every other chunk in file order.
With ``partial=True`` a truncated file gives the frames that arrived
whole (libwebp's WebPDemuxPartial).  Host parsing only: no pixels, no
device.  Written from the WebP container spec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..constants import (ANMF_FLAG_DISPOSE_BACKGROUND, ANMF_FLAG_NO_BLEND,
                         CHUNK_ALPHA, CHUNK_ANIM, CHUNK_ANMF, CHUNK_EXIF,
                         CHUNK_ICCP, CHUNK_VP8, CHUNK_VP8L, CHUNK_VP8X,
                         CHUNK_XMP, VP8X_FLAG_ALPHA, VP8X_FLAG_ANIMATION)
from ..errors import BitstreamError
from .riff import (Chunk, _u24le, parse_riff, vp8_dimensions,
                   vp8l_dimensions)


@dataclass
class FrameInfo:
    """One still or animation frame: placement, timing and its payloads."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    duration_ms: int = 0
    dispose_background: bool = False
    blend: bool = True
    is_lossless: bool = False
    image_payload: bytes = b""
    alpha_payload: bytes | None = None


@dataclass
class Demuxer:
    """A demuxed file: canvas, animation parameters, frames, metadata."""

    canvas_width: int = 0
    canvas_height: int = 0
    has_alpha: bool = False
    has_animation: bool = False
    loop_count: int = 0
    background_color: int = 0xFFFFFFFF
    frames: list[FrameInfo] = field(default_factory=list)
    iccp: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None
    # chunks of no other kind, kept in file order
    unknown_chunks: list[Chunk] = field(default_factory=list)
    is_partial: bool = False  # the tolerant parse dropped a truncated tail

    @property
    def num_frames(self) -> int:
        return len(self.frames)


def _parse_image_chunks(chunks: list[Chunk], frame: FrameInfo) -> None:
    for c in chunks:
        if c.tag == CHUNK_ALPHA:
            frame.alpha_payload = c.payload
        elif c.tag == CHUNK_VP8:
            frame.image_payload = c.payload
            frame.is_lossless = False
        elif c.tag == CHUNK_VP8L:
            frame.image_payload = c.payload
            frame.is_lossless = True


def _split_subchunks(data: bytes) -> list[Chunk]:
    """The chunks inside an ANMF payload (after its 16-byte header)."""
    out = []
    pos = 0
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append(Chunk(tag, data[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def demux(data: bytes, *, partial: bool = False) -> Demuxer:
    """Parse a container into a ``Demuxer``.

    With ``partial=True`` a truncated file is accepted: every complete
    frame is returned and ``is_partial`` is set.  Without it a truncated
    file raises NotEnoughData.
    """
    parsed = parse_riff(data, tolerant=partial)
    d = Demuxer(is_partial=parsed.truncated)
    d.canvas_width = parsed.canvas_width
    d.canvas_height = parsed.canvas_height
    d.has_alpha = bool(parsed.vp8x_flags & VP8X_FLAG_ALPHA)
    d.has_animation = bool(parsed.vp8x_flags & VP8X_FLAG_ANIMATION)

    pending_alpha: bytes | None = None
    for c in parsed.chunks:
        if c.truncated:
            # drop the incomplete tail chunk, keep everything before it
            d.is_partial = True
            break
        if c.tag == CHUNK_ANIM:
            if len(c.payload) >= 6:
                d.background_color, d.loop_count = struct.unpack_from(
                    "<IH", c.payload, 0)
        elif c.tag == CHUNK_ANMF:
            if len(c.payload) < 16:
                raise BitstreamError("short ANMF chunk")
            f = FrameInfo()
            f.x = 2 * _u24le(c.payload, 0)
            f.y = 2 * _u24le(c.payload, 3)
            f.width = 1 + _u24le(c.payload, 6)
            f.height = 1 + _u24le(c.payload, 9)
            f.duration_ms = _u24le(c.payload, 12)
            flags = c.payload[15]
            f.dispose_background = bool(flags & ANMF_FLAG_DISPOSE_BACKGROUND)
            f.blend = not (flags & ANMF_FLAG_NO_BLEND)
            _parse_image_chunks(_split_subchunks(c.payload[16:]), f)
            d.frames.append(f)
        elif c.tag == CHUNK_ICCP:
            d.iccp = c.payload
        elif c.tag == CHUNK_EXIF:
            d.exif = c.payload
        elif c.tag == CHUNK_XMP:
            d.xmp = c.payload
        elif c.tag == CHUNK_ALPHA:
            pending_alpha = c.payload
        elif c.tag in (CHUNK_VP8, CHUNK_VP8L):
            d.frames.append(FrameInfo(
                width=d.canvas_width, height=d.canvas_height,
                is_lossless=c.tag == CHUNK_VP8L, image_payload=c.payload,
                alpha_payload=pending_alpha, blend=False))
            pending_alpha = None
        elif c.tag != CHUNK_VP8X:
            d.unknown_chunks.append(Chunk(c.tag, c.payload))

    if not parsed.has_vp8x and d.frames:
        # a simple file: the canvas is the frame
        f = d.frames[0]
        if f.is_lossless:
            w, h, d.has_alpha = vp8l_dimensions(f.image_payload)
        else:
            w, h = vp8_dimensions(f.image_payload)
            d.has_alpha = f.alpha_payload is not None
        d.canvas_width, d.canvas_height = w, h
        f.width, f.height = w, h
    return d


__all__ = ["Demuxer", "FrameInfo", "demux"]
