"""RIFF container parsing and assembly for WebP files.

The writer emits a RIFF wrapper holding one bare "VP8 " chunk, which is
all the batch lossy encode emits.  The reader splits a WebP file (simple
or VP8X extended) into its chunks, which the batch decode routes by,
checks and reads the VP8X header, and probes a VP8 key frame's
dimensions.  Written from the WebP container
spec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..constants import (CHUNK_HEADER_SIZE, CHUNK_VP8X, RIFF_HEADER_SIZE,
                         RIFF_MAGIC, VP8_SIGNATURE, VP8X_CHUNK_SIZE,
                         WEBP_MAGIC)
from ..errors import BitstreamError, NotEnoughData


@dataclass
class Chunk:
    """A single RIFF chunk: fourcc tag plus raw payload bytes."""

    tag: bytes
    payload: bytes

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
    chunks: list[Chunk] = field(default_factory=list)

    def find(self, tag: bytes) -> Chunk | None:
        """The first chunk with this fourcc, or None."""
        for c in self.chunks:
            if c.tag == tag:
                return c
        return None


def parse_riff(data: bytes) -> ParsedWebP:
    """Split a .webp byte string into its chunks; a truncated file or a
    VP8X chunk shorter than its 10 bytes raises."""
    if len(data) < RIFF_HEADER_SIZE:
        raise NotEnoughData("file shorter than RIFF header")
    if data[0:4] != RIFF_MAGIC or data[8:12] != WEBP_MAGIC:
        raise BitstreamError("not a RIFF/WEBP file")
    riff_size = struct.unpack_from("<I", data, 4)[0]
    if riff_size < 4:
        raise BitstreamError("RIFF size too small")
    if len(data) < 8 + riff_size:
        raise NotEnoughData("file shorter than RIFF size field declares")
    end = 8 + riff_size

    parsed = ParsedWebP()
    pos = RIFF_HEADER_SIZE
    while pos + CHUNK_HEADER_SIZE <= end:
        tag = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        payload_start = pos + CHUNK_HEADER_SIZE
        if payload_start + size > end:
            raise NotEnoughData(f"chunk {tag!r} truncated")
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


def assemble(chunks: list[Chunk]) -> bytes:
    """Wrap chunks in a RIFF/WEBP container."""
    body = b"".join(c.serialize() for c in chunks)
    return RIFF_MAGIC + struct.pack("<I", 4 + len(body)) + WEBP_MAGIC + body


def assemble_simple(image_chunk: Chunk) -> bytes:
    """Simple (non-extended) file: RIFF + single VP8/VP8L chunk."""
    return assemble([image_chunk])


__all__ = ["Chunk", "ParsedWebP", "assemble", "assemble_simple",
           "parse_riff", "vp8_dimensions"]
