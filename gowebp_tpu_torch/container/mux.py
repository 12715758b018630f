"""Muxer: assemble and edit WebP containers (images, frames, metadata).

``Mux`` holds a file's frames, its ICCP, EXIF and XMP payloads, its
animation parameters, an optional explicit canvas and any other chunks;
``assemble`` writes the container, adding a VP8X header where the file
needs one (animation, metadata, a still image with an ALPH chunk) and
collapsing a single frame to a still image.  Host byte work only: no
pixels, no device.  libwebp's WebPMux API, written from the WebP
container spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..constants import (CHUNK_ALPHA, CHUNK_ANIM, CHUNK_ANMF, CHUNK_EXIF,
                         CHUNK_ICCP, CHUNK_VP8, CHUNK_VP8L, CHUNK_XMP)
from ..errors import WebPError
from .riff import (Chunk, assemble, build_anim_chunk, build_anmf_header,
                   build_vp8x, vp8_dimensions, vp8l_dimensions)


@dataclass
class MuxFrame:
    """One frame's image payloads, placement and timing."""

    image_payload: bytes
    is_lossless: bool
    alpha_payload: bytes | None = None
    x: int = 0
    y: int = 0
    duration_ms: int = 100
    dispose_background: bool = False
    blend: bool = True

    def dims(self) -> tuple[int, int]:
        """Width and height from the image payload's header."""
        if self.is_lossless:
            w, h, _ = vp8l_dimensions(self.image_payload)
        else:
            w, h = vp8_dimensions(self.image_payload)
        return w, h

    def has_alpha(self) -> bool:
        if self.alpha_payload is not None:
            return True
        if self.is_lossless:
            return vp8l_dimensions(self.image_payload)[2]
        return False


_META_TAGS = {CHUNK_ICCP: "iccp", CHUNK_EXIF: "exif", CHUNK_XMP: "xmp"}


def _tag(fourcc: bytes | str) -> bytes:
    return fourcc.encode("ascii") if isinstance(fourcc, str) else fourcc


@dataclass
class Mux:
    """Chunk-level editor; ``assemble()`` gives the file's bytes."""

    frames: list[MuxFrame] = field(default_factory=list)
    iccp: bytes | None = None
    exif: bytes | None = None
    xmp: bytes | None = None
    loop_count: int = 0
    background_color: int = 0xFFFFFFFF
    canvas_width: int = 0     # 0: the frames' bounding box
    canvas_height: int = 0
    # chunks of any other fourcc, written verbatim after the metadata
    unknown_chunks: list[Chunk] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Mux":
        """An editable Mux of an existing file: its frames, metadata,
        animation parameters and other chunks."""
        from .demux import demux

        d = demux(data)
        m = cls(iccp=d.iccp, exif=d.exif, xmp=d.xmp,
                loop_count=d.loop_count, background_color=d.background_color)
        if d.has_animation:
            m.canvas_width = d.canvas_width
            m.canvas_height = d.canvas_height
        for f in d.frames:
            m.frames.append(MuxFrame(
                f.image_payload, f.is_lossless, f.alpha_payload,
                x=f.x, y=f.y, duration_ms=f.duration_ms,
                dispose_background=f.dispose_background, blend=f.blend))
        m.unknown_chunks = list(d.unknown_chunks)
        return m

    def set_image(self, image_payload: bytes, is_lossless: bool,
                  alpha_payload: bytes | None = None) -> None:
        """Replace every frame with one still image."""
        self.frames = [MuxFrame(image_payload, is_lossless, alpha_payload)]

    def push_frame(self, frame: MuxFrame) -> None:
        self.frames.append(frame)

    def delete_frame(self, index: int) -> None:
        del self.frames[index]

    def set_chunk(self, fourcc: bytes | str, payload: bytes) -> None:
        """Set a metadata or other chunk by fourcc, replacing one that is
        there; image and animation chunks raise WebPError."""
        tag = _tag(fourcc)
        if len(tag) != 4:
            raise WebPError("chunk fourcc must be 4 bytes")
        if tag in _META_TAGS:
            setattr(self, _META_TAGS[tag], payload)
            return
        if tag in (CHUNK_VP8, CHUNK_VP8L, CHUNK_ALPHA, CHUNK_ANIM, CHUNK_ANMF):
            raise WebPError(f"use the image/frame API for {tag!r} chunks")
        self.delete_chunk(tag)
        self.unknown_chunks.append(Chunk(tag, payload))

    def get_chunk(self, fourcc: bytes | str) -> bytes | None:
        tag = _tag(fourcc)
        if tag in _META_TAGS:
            return getattr(self, _META_TAGS[tag])
        for c in self.unknown_chunks:
            if c.tag == tag:
                return c.payload
        return None

    def delete_chunk(self, fourcc: bytes | str) -> None:
        tag = _tag(fourcc)
        if tag in _META_TAGS:
            setattr(self, _META_TAGS[tag], None)
            return
        self.unknown_chunks = [c for c in self.unknown_chunks if c.tag != tag]

    def set_animation_params(self, *, background_color: int | None = None,
                             loop_count: int | None = None) -> None:
        if background_color is not None:
            self.background_color = background_color & 0xFFFFFFFF
        if loop_count is not None:
            if not 0 <= loop_count < (1 << 16):
                raise WebPError("loop_count out of range")
            self.loop_count = loop_count

    def set_canvas_size(self, width: int, height: int) -> None:
        """An explicit canvas; every frame must fit it."""
        if width < 0 or height < 0 or width > 1 << 24 or height > 1 << 24:
            raise WebPError("bad canvas size")
        for f in self.frames:
            fw, fh = f.dims()
            if width and (f.x + fw > width or f.y + fh > height):
                raise WebPError("canvas smaller than a frame")
        self.canvas_width, self.canvas_height = width, height

    def _canvas(self) -> tuple[int, int]:
        if self.canvas_width and self.canvas_height:
            return self.canvas_width, self.canvas_height
        w = h = 0
        for f in self.frames:
            fw, fh = f.dims()
            w = max(w, f.x + fw)
            h = max(h, f.y + fh)
        return w, h

    def assemble(self) -> bytes:
        """The file: VP8X when there is animation, metadata or a still
        frame with an alpha payload; then ICCP, ANIM and the ANMF frames
        (or the still's ALPH and image chunk), EXIF, XMP and the other
        chunks."""
        if not self.frames:
            raise WebPError("no image to assemble")
        animated = len(self.frames) > 1
        has_alpha = any(f.has_alpha() for f in self.frames)
        has_meta = any(x is not None for x in (self.iccp, self.exif, self.xmp))
        w, h = self._canvas()
        # a still frame with an alpha payload takes the extended header,
        # lossless or not
        need_vp8x = (animated or has_meta
                     or self.frames[0].alpha_payload is not None)

        chunks: list[Chunk] = []
        if need_vp8x:
            chunks.append(build_vp8x(
                w, h, has_alpha=has_alpha, has_animation=animated,
                has_icc=self.iccp is not None, has_exif=self.exif is not None,
                has_xmp=self.xmp is not None))
        if self.iccp is not None:
            chunks.append(Chunk(CHUNK_ICCP, self.iccp))
        if animated:
            chunks.append(build_anim_chunk(self.background_color,
                                           self.loop_count))
            for f in self.frames:
                fw, fh = f.dims()
                body = build_anmf_header(
                    f.x, f.y, fw, fh, f.duration_ms,
                    dispose_background=f.dispose_background,
                    no_blend=not f.blend)
                if f.alpha_payload is not None and not f.is_lossless:
                    body += Chunk(CHUNK_ALPHA, f.alpha_payload).serialize()
                tag = CHUNK_VP8L if f.is_lossless else CHUNK_VP8
                body += Chunk(tag, f.image_payload).serialize()
                chunks.append(Chunk(CHUNK_ANMF, body))
        else:
            f = self.frames[0]
            if f.alpha_payload is not None and not f.is_lossless:
                chunks.append(Chunk(CHUNK_ALPHA, f.alpha_payload))
            tag = CHUNK_VP8L if f.is_lossless else CHUNK_VP8
            chunks.append(Chunk(tag, f.image_payload))
        if self.exif is not None:
            chunks.append(Chunk(CHUNK_EXIF, self.exif))
        if self.xmp is not None:
            chunks.append(Chunk(CHUNK_XMP, self.xmp))
        chunks.extend(self.unknown_chunks)
        return assemble(chunks)


__all__ = ["Mux", "MuxFrame"]
