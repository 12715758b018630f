"""RIFF container parsing and assembly for WebP files.

The writer emits a RIFF wrapper holding one bare "VP8 " chunk (a simple
file), or a VP8X header, an ALPH chunk and the "VP8 " chunk (a lossy
file with alpha), and builds the VP8X (with its alpha, animation, ICC,
EXIF and XMP flags), ANIM and ANMF headers the muxer assembles.  The
reader splits a WebP file (simple or VP8X extended) into its chunks,
which the decode and the demuxer route by, checks and reads the VP8X
header, probes a VP8 key frame's or a VP8L header's dimensions, and
reports a file's features without decoding it.  Written from the WebP
container spec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..constants import (ANIM_CHUNK_SIZE, ANMF_CHUNK_SIZE,
                         ANMF_FLAG_DISPOSE_BACKGROUND, ANMF_FLAG_NO_BLEND,
                         CHUNK_ALPHA, CHUNK_ANIM, CHUNK_ANMF,
                         CHUNK_HEADER_SIZE, CHUNK_VP8, CHUNK_VP8L, CHUNK_VP8X,
                         RIFF_HEADER_SIZE, RIFF_MAGIC, VP8_SIGNATURE,
                         VP8L_SIGNATURE, VP8X_CHUNK_SIZE, VP8X_FLAG_ALPHA,
                         VP8X_FLAG_ANIMATION, VP8X_FLAG_EXIF, VP8X_FLAG_ICC,
                         VP8X_FLAG_XMP, WEBP_MAGIC)
from ..errors import BitstreamError, NotEnoughData


@dataclass
class Chunk:
    """A single RIFF chunk: fourcc tag plus raw payload bytes."""

    tag: bytes
    payload: bytes
    truncated: bool = False  # tolerant parse: payload shorter than declared

    @property
    def padded_size(self) -> int:
        return CHUNK_HEADER_SIZE + len(self.payload) + (len(self.payload) & 1)

    def serialize(self) -> bytes:
        out = self.tag + struct.pack("<I", len(self.payload)) + self.payload
        if len(self.payload) & 1:
            out += b"\x00"
        return out


@dataclass
class ParsedWebP:
    """Split-up container: the VP8X header's fields, if the file has one,
    and every chunk in order."""

    canvas_width: int = 0
    canvas_height: int = 0
    vp8x_flags: int = 0
    has_vp8x: bool = False
    truncated: bool = False  # tolerant parse: data ends before the RIFF size
    chunks: list[Chunk] = field(default_factory=list)

    def find(self, tag: bytes) -> Chunk | None:
        """The first chunk with this fourcc, or None."""
        for c in self.chunks:
            if c.tag == tag:
                return c
        return None

    def find_all(self, tag: bytes) -> list[Chunk]:
        """Every chunk with this fourcc, in file order."""
        return [c for c in self.chunks if c.tag == tag]


def parse_riff(data: bytes, tolerant: bool = False) -> ParsedWebP:
    """Split a .webp byte string into its chunks; a truncated file or a
    VP8X chunk shorter than its 10 bytes raises.

    With ``tolerant=True`` (the incremental decoder) a file shorter than
    its RIFF size parses: the last chunk keeps the bytes that arrived and
    is marked ``truncated``, and so is the result.
    """
    if len(data) < RIFF_HEADER_SIZE:
        raise NotEnoughData("file shorter than RIFF header")
    if data[0:4] != RIFF_MAGIC or data[8:12] != WEBP_MAGIC:
        raise BitstreamError("not a RIFF/WEBP file")
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 4:
        raise BitstreamError("RIFF size too small")
    if not tolerant and len(data) < 8 + riff_size:
        raise NotEnoughData("file shorter than RIFF size field declares")
    end = min(len(data), 8 + riff_size)

    parsed = ParsedWebP(truncated=len(data) < 8 + riff_size)
    pos = RIFF_HEADER_SIZE
    while pos + CHUNK_HEADER_SIZE <= end:
        tag = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        payload_start = pos + CHUNK_HEADER_SIZE
        if payload_start + size > end:
            if not tolerant:
                raise NotEnoughData(f"chunk {tag!r} truncated")
            parsed.chunks.append(Chunk(tag, data[payload_start:end],
                                       truncated=True))
            break
        parsed.chunks.append(Chunk(tag, data[payload_start : payload_start + size]))
        pos = payload_start + size + (size & 1)

    vp8x = parsed.find(CHUNK_VP8X)
    if vp8x is not None:
        if len(vp8x.payload) < VP8X_CHUNK_SIZE:
            raise BitstreamError("VP8X chunk too small")
        parsed.has_vp8x = True
        parsed.vp8x_flags = struct.unpack_from("<I", vp8x.payload, 0)[0]
        parsed.canvas_width = 1 + _u24le(vp8x.payload, 4)
        parsed.canvas_height = 1 + _u24le(vp8x.payload, 7)
    return parsed


def _u24le(b: bytes, off: int) -> int:
    return b[off] | (b[off + 1] << 8) | (b[off + 2] << 16)


def vp8_dimensions(payload: bytes) -> tuple[int, int]:
    """Width/height from a VP8 key frame payload (RFC 6386 §9.1)."""
    if len(payload) < 10:
        raise NotEnoughData("VP8 payload too small for frame header")
    tag = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    if tag & 1:
        raise BitstreamError("first VP8 frame is not a key frame")
    if ((payload[3] << 16) | (payload[4] << 8) | payload[5]) != VP8_SIGNATURE:
        raise BitstreamError("bad VP8 start code")
    w = struct.unpack_from("<H", payload, 6)[0] & 0x3FFF
    h = struct.unpack_from("<H", payload, 8)[0] & 0x3FFF
    return w, h


def vp8l_dimensions(payload: bytes) -> tuple[int, int, bool]:
    """Width, height and alpha hint from a VP8L header (5 bytes)."""
    if len(payload) < 5:
        raise NotEnoughData("VP8L payload too small")
    if payload[0] != VP8L_SIGNATURE:
        raise BitstreamError("bad VP8L signature byte")
    bits = struct.unpack_from("<I", payload, 1)[0]
    w = (bits & 0x3FFF) + 1
    h = ((bits >> 14) & 0x3FFF) + 1
    alpha = bool((bits >> 28) & 1)
    version = (bits >> 29) & 0x7
    if version != 0:
        raise BitstreamError(f"unsupported VP8L version {version}")
    return w, h, alpha


@dataclass
class WebPFeatures:
    """Probe result: what is in this file (WebPGetFeatures)."""

    width: int
    height: int
    has_alpha: bool
    has_animation: bool
    format: str  # "lossy" | "lossless" | "mixed" | "undefined"


def get_features(data: bytes, tolerant: bool = False) -> WebPFeatures:
    """WebPGetFeatures: probe a file without decoding it; ``tolerant``
    probes the headers of a file that has not all arrived."""
    parsed = parse_riff(data, tolerant=tolerant)
    vp8 = parsed.find(CHUNK_VP8)
    vp8l = parsed.find(CHUNK_VP8L)
    has_anim = bool(parsed.vp8x_flags & VP8X_FLAG_ANIMATION)
    if parsed.has_vp8x:
        width, height = parsed.canvas_width, parsed.canvas_height
        has_alpha = bool(parsed.vp8x_flags & VP8X_FLAG_ALPHA)
    elif vp8l is not None:
        width, height, has_alpha = vp8l_dimensions(vp8l.payload)
    elif vp8 is not None:
        width, height = vp8_dimensions(vp8.payload)
        has_alpha = parsed.find(CHUNK_ALPHA) is not None
    else:
        raise BitstreamError("no image chunk (VP8/VP8L/VP8X) found")
    if vp8l is not None:
        fmt = "lossless"
    elif vp8 is not None:
        fmt = "lossy"
    elif has_anim or parsed.find(CHUNK_ANMF) is not None:
        fmt = "mixed"
    else:
        fmt = "undefined"
    return WebPFeatures(width, height, has_alpha, has_anim, fmt)


def build_vp8x(width: int, height: int, *, has_alpha: bool = False,
               has_animation: bool = False, has_icc: bool = False,
               has_exif: bool = False, has_xmp: bool = False) -> Chunk:
    """The VP8X extended-header chunk: the feature flags and the canvas."""
    flags = 0
    for on, bit in ((has_alpha, VP8X_FLAG_ALPHA),
                    (has_animation, VP8X_FLAG_ANIMATION),
                    (has_icc, VP8X_FLAG_ICC), (has_exif, VP8X_FLAG_EXIF),
                    (has_xmp, VP8X_FLAG_XMP)):
        if on:
            flags |= bit
    payload = (struct.pack("<I", flags) + _pack_u24le(width - 1)
               + _pack_u24le(height - 1))
    return Chunk(CHUNK_VP8X, payload)


def build_anim_chunk(background_color: int = 0xFFFFFFFF,
                     loop_count: int = 0) -> Chunk:
    """The ANIM chunk: background colour (BGRA) and loop count."""
    return Chunk(CHUNK_ANIM, struct.pack("<IH", background_color, loop_count))


def build_anmf_header(x: int, y: int, width: int, height: int,
                      duration_ms: int, *, dispose_background: bool = False,
                      no_blend: bool = False) -> bytes:
    """The 16-byte ANMF frame header; the frame's image chunks follow it.
    An odd offset raises ValueError (the format stores x/2 and y/2)."""
    if x % 2 or y % 2:
        raise ValueError("ANMF frame offsets must be even")
    flags = ((ANMF_FLAG_NO_BLEND if no_blend else 0)
             | (ANMF_FLAG_DISPOSE_BACKGROUND if dispose_background else 0))
    return (_pack_u24le(x // 2) + _pack_u24le(y // 2)
            + _pack_u24le(width - 1) + _pack_u24le(height - 1)
            + _pack_u24le(duration_ms) + bytes([flags]))


def _pack_u24le(v: int) -> bytes:
    return bytes((v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF))


def assemble(chunks: list[Chunk]) -> bytes:
    """Wrap chunks in a RIFF/WEBP container."""
    body = b"".join(c.serialize() for c in chunks)
    return RIFF_MAGIC + struct.pack("<I", 4 + len(body)) + WEBP_MAGIC + body


def assemble_simple(image_chunk: Chunk) -> bytes:
    """Simple (non-extended) file: RIFF + single VP8/VP8L chunk."""
    return assemble([image_chunk])


__all__ = ["ANIM_CHUNK_SIZE", "ANMF_CHUNK_SIZE", "Chunk", "ParsedWebP",
           "WebPFeatures", "assemble", "assemble_simple", "build_anim_chunk",
           "build_anmf_header", "build_vp8x", "get_features", "parse_riff",
           "vp8_dimensions", "vp8l_dimensions"]
