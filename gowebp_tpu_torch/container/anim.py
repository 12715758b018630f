"""Animation decode (the canvas state machine) and encode.

``decode_animation`` decodes every frame of an animated (or still) file
in one ``decode_rgba_batch`` call on the device, then composites them on
the host in file order: blend (non-premultiplied src-over) or overwrite,
then dispose to background.  ``AnimationEncoder`` encodes each candidate
sub-frame through ``encode_rgba`` on the device and keeps libwebp's
WebPAnimEncoder policies: even-aligned change rectangles, identical-frame
duration merging, the blanking and dispose-to-background candidates, the
kmin/kmax keyframe policy, lossy-or-lossless candidates with
``allow_mixed``, and a single frame collapsed to a still image.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import CHUNK_ALPHA, CHUNK_VP8, CHUNK_VP8L
from ..device import resolve_device
from ..errors import WebPError
from .demux import Demuxer, FrameInfo, demux
from .mux import Mux, MuxFrame
from .riff import Chunk, assemble, build_vp8x, parse_riff


def _still_file(f: FrameInfo) -> bytes:
    """A frame's payloads as a still file: VP8L, VP8, or VP8X (the alpha
    flag, the frame's size), ALPH and VP8."""
    if f.is_lossless:
        return assemble([Chunk(CHUNK_VP8L, f.image_payload)])
    if f.alpha_payload is None:
        return assemble([Chunk(CHUNK_VP8, f.image_payload)])
    return assemble([build_vp8x(f.width, f.height, has_alpha=True),
                     Chunk(CHUNK_ALPHA, f.alpha_payload),
                     Chunk(CHUNK_VP8, f.image_payload)])


def _blend_nonpremult(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Src-over blend, libwebp's integer form (non-premultiplied)."""
    src_i = src.astype(np.int32)
    dst_i = dst.astype(np.int32)
    src_a = src_i[..., 3]
    dst_a = dst_i[..., 3]
    scale = (dst_a * (255 - src_a)) // 255
    blend_a = src_a + scale
    safe = np.maximum(blend_a, 1)
    out = np.empty_like(src)
    for c in range(3):
        out[..., c] = (src_i[..., c] * src_a + dst_i[..., c] * scale) // safe
    out[..., 3] = blend_a
    out[blend_a == 0] = 0
    # an opaque source pixel replaces, a transparent one keeps the canvas
    opaque = src_a == 255
    out[opaque] = src[opaque]
    clear = src_a == 0
    out[clear] = dst[clear]
    return out


@dataclass
class AnimFrame:
    """One composited canvas, (H, W, 4) uint8, and its display time."""

    rgba: np.ndarray
    duration_ms: int


def decode_animation(data: bytes, *,
                     device=None) -> tuple[list[AnimFrame], Demuxer]:
    """Decode every frame to a full-canvas RGBA array, composited.

    The frames decode in one ``decode_rgba_batch`` call on ``device``
    (None means CUDA and raises without it; ``device="cpu"`` runs the
    kernels' plain versions with identical pixels); lossless frames
    decode on the host whatever ``device`` says.  The canvases are host
    uint8 arrays.  A frame that does not fit the canvas raises ValueError.
    """
    from ..decode import decode_rgba_batch

    dev = resolve_device(device)
    d = demux(data)
    W, H = d.canvas_width, d.canvas_height
    canvas = np.zeros((H, W, 4), np.uint8)
    decoded = decode_rgba_batch([_still_file(f) for f in d.frames],
                                device=dev)
    out = []
    for f, rgba in zip(d.frames, decoded):
        fh, fw = rgba.shape[:2]
        region = canvas[f.y : f.y + fh, f.x : f.x + fw]
        if f.blend:
            region[:] = _blend_nonpremult(rgba, region)
        else:
            region[:] = rgba
        out.append(AnimFrame(canvas.copy(), f.duration_ms))
        if f.dispose_background:
            canvas[f.y : f.y + fh, f.x : f.x + fw] = 0
    return out, d


def _encode_candidate(sub: np.ndarray, lossless: bool, quality: float,
                      device) -> bytes:
    from ..config import EncoderConfig
    from ..encode import encode_rgba

    cfg = EncoderConfig(lossless=lossless, quality=quality)
    return encode_rgba(np.ascontiguousarray(sub), config=cfg, device=device)


def _payloads(data: bytes) -> MuxFrame:
    parsed = parse_riff(data)
    vp8l = parsed.find(CHUNK_VP8L)
    vp8 = parsed.find(CHUNK_VP8)
    alpha = parsed.find(CHUNK_ALPHA)
    if vp8l is not None:
        return MuxFrame(vp8l.payload, True, None)
    if vp8 is not None:
        return MuxFrame(vp8.payload, False, alpha.payload if alpha else None)
    raise WebPError("internal: no image chunk produced")


class AnimationEncoder:
    """Accumulate frames, then assemble an animated WebP.

    libwebp's WebPAnimEncoder policies:
    - a frame identical to the canvas extends the previous frame's
      duration;
    - a changed frame encodes only its change rectangle, widened to even
      offsets, and overwrites;
    - for a lossless sub-frame whose changed pixels are all opaque, a
      second candidate blanks the unchanged pixels to transparent and
      blends; the smaller file wins;
    - with ``allow_mixed`` a lossy and a lossless candidate are tried
      for each sub-frame;
    - a dispose-to-background candidate re-derives the change against
      the canvas with the previous frame's rectangle cleared;
    - ``kmax``/``kmin``: after ``kmax`` delta frames a full-canvas
      keyframe is forced; from ``kmin`` on a keyframe is taken when it is
      no larger than the delta.  ``kmax=0`` forces none, ``kmax=1`` makes
      every frame a keyframe.

    Every candidate encodes through ``encode_rgba`` on ``device``,
    resolved once here: None means CUDA and raises without it;
    ``device="cpu"`` runs the kernels' plain versions (identical bytes).
    """

    def __init__(self, *, loop_count: int = 0,
                 background_color: int = 0xFFFFFFFF,
                 minimize_size: bool = True,
                 allow_mixed: bool = False,
                 kmin: int = 0, kmax: int = 0, device=None):
        self._device = resolve_device(device)
        self._mux = Mux(loop_count=loop_count,
                        background_color=background_color)
        self._minimize = minimize_size
        self._allow_mixed = allow_mixed
        if kmax == 1:
            kmin, kmax = 0, 1
        elif kmax > 1 and kmin >= kmax:
            kmin = kmax - 1
        self._kmin, self._kmax = kmin, kmax
        self._since_key = 0
        self._last_blend = False
        self._canvas: np.ndarray | None = None
        self._prev_rect: tuple | None = None

    def _candidates(self, sub: np.ndarray, changed: np.ndarray | None,
                    lossless: bool, quality: float) -> bytes:
        """Encode every codec and compositing candidate of ``sub``; the
        smallest file.  ``changed`` is ``sub``'s change mask (None for a
        keyframe or the first frame)."""
        modes = [True, False] if self._allow_mixed else [lossless]
        best: tuple[bytes, bool] | None = None
        for ll in modes:
            data = _encode_candidate(sub, ll, quality, self._device)
            if best is None or len(data) < len(best[0]):
                best = (data, False)
            # blanking: exact only when lossless and every changed pixel
            # is opaque (src-over is then an overwrite)
            if (ll and changed is not None and not changed.all()
                    and bool(sub[changed][:, 3].min(initial=255) == 255)):
                blanked = sub.copy()
                blanked[~changed] = 0
                data2 = _encode_candidate(blanked, True, quality,
                                          self._device)
                if len(data2) < len(best[0]):
                    best = (data2, True)
        self._last_blend = best[1]
        return best[0]

    def add_frame(self, rgba: np.ndarray, duration_ms: int, *,
                  lossless: bool = True, quality: float = 75.0) -> None:
        """Add an (H, W, 3|4) uint8 frame shown for ``duration_ms``."""
        rgba = np.asarray(rgba)
        if rgba.shape[-1] == 3:
            rgba = np.concatenate(
                [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], -1)
        force_key = (self._kmax == 1
                     or (self._kmax > 1 and self._since_key >= self._kmax))
        try_key = (self._kmax > 1 and self._since_key >= self._kmin)

        def delta_against(ref_canvas):
            """(sub, changed, x, y): the even-aligned change rectangle of
            ``rgba`` against ``ref_canvas`` (None if identical)."""
            diff = (rgba != ref_canvas).any(axis=-1)
            if not diff.any():
                return None
            ys, xs = np.nonzero(diff)
            y0, y1 = int(ys.min()), int(ys.max()) + 1
            x0, x1 = int(xs.min()), int(xs.max()) + 1
            x0 &= ~1               # ANMF offsets must be even
            y0 &= ~1
            return rgba[y0:y1, x0:x1], diff[y0:y1, x0:x1], x0, y0

        x = y = 0
        sub = rgba
        changed = None
        prev_bg = False
        prev_canvas = self._canvas      # the canvas after the last frame
        if (self._minimize and prev_canvas is not None
                and prev_canvas.shape == rgba.shape):
            d_none = delta_against(prev_canvas)
            if d_none is None:
                # identical: merge into the previous duration, before any
                # keyframe policy (no frame is emitted)
                if self._mux.frames:
                    self._mux.frames[-1].duration_ms += duration_ms
                    self._canvas = rgba.copy()
                    return
            if not force_key:
                sub, changed, x, y = d_none
        self._canvas = rgba.copy()

        data = self._candidates(sub, changed, lossless, quality)
        blend = self._last_blend

        # dispose to background: the delta as if the previous frame's
        # rectangle were cleared to transparent first, the only cheap
        # way to erase (src-over never lowers alpha)
        if (self._minimize and not force_key and changed is not None
                and self._prev_rect is not None and self._mux.frames
                and prev_canvas is not None):
            px, py, ph, pw = self._prev_rect
            bg_canvas = prev_canvas.copy()
            bg_canvas[py:py + ph, px:px + pw] = 0
            d_bg = delta_against(bg_canvas)
            if d_bg is not None:
                sub2, changed2, x2, y2 = d_bg
                data2 = self._candidates(sub2, changed2, lossless, quality)
                if len(data2) < len(data):
                    data, blend = data2, self._last_blend
                    sub, changed, x, y = sub2, changed2, x2, y2
                    prev_bg = True

        is_delta = sub.shape[:2] != rgba.shape[:2] or blend
        if is_delta and try_key:
            key_data = _encode_candidate(rgba, lossless, quality,
                                         self._device)
            if len(key_data) <= len(data):
                data, blend, x, y, is_delta = key_data, False, 0, 0, False
                prev_bg = False

        if prev_bg:
            self._mux.frames[-1].dispose_background = True
        frame = _payloads(data)
        frame.duration_ms = duration_ms
        frame.blend = blend
        frame.x = x
        frame.y = y
        self._mux.push_frame(frame)
        self._since_key = self._since_key + 1 if is_delta else 1
        self._prev_rect = (x, y, sub.shape[0], sub.shape[1])

    def assemble(self) -> bytes:
        """The file; one frame collapses to a still image (the Mux writes
        the simple container for a single frame)."""
        return self._mux.assemble()


__all__ = ["AnimFrame", "AnimationEncoder", "decode_animation"]
