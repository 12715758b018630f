"""Top-level encode API of the PyTorch port: the single-image encode
(lossy and lossless) and the batch encode."""

from __future__ import annotations

import numpy as np

from .config import EncoderConfig
from .errors import EncodeError


def encode_rgba(rgba: np.ndarray, *, lossless: bool = False,
                quality: float = 75.0, method: int = 4,
                config: EncoderConfig | None = None, stats=None,
                device=None) -> bytes:
    """Encode an (H, W, 3|4) uint8 array into a .webp byte string.

    The reference's ``encode_rgba``: lossy VP8 at quality 75 by default,
    every lossy ``EncoderConfig`` field, an ALPH chunk (VP8L-coded alpha)
    when the image has non-opaque pixels; ``config.plane_backend`` picks
    which of the reference's backends' decisions (and bytes) it gives.
    The dense phase, and the frame's own decodes (filter-level trials,
    target PSNR, ``stats.psnr``), run on ``device``: None means CUDA and
    raises without it, before any work; ``device="cpu"`` runs the
    kernels' plain versions and gives identical bytes.  YUV conversion,
    segmentation, token emission and the ALPH coder run on the host.

    ``lossless=True`` (or ``config.lossless``): a VP8L file, with
    ``near_lossless`` < 100 preprocessing and ``image_hint``.  The
    encoder runs on the host except the predictor chooser of an image of
    1 MP or more, which runs on ``device`` when it is CUDA (the kernel
    ``predictor_search_entropy``; with $GOWEBP_TPU_VP8L_ANALYSIS=1 every
    image takes that chooser, on the card or as its plain version on
    the CPU).  Elsewhere the bytes are the reference's; the device
    chooser may pick another mode on a near tie.
    ``stats``: an ``EncodeStats`` to fill.
    """
    from .device import resolve_device
    from .models.vp8.encoder import encode_vp8_webp

    dev = resolve_device(device)
    if config is None:
        config = EncoderConfig(lossless=lossless, quality=quality, method=method)
    config.validate()
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise EncodeError("expected uint8 pixels")
    if (not config.exact and rgba.ndim == 3 and rgba.shape[2] == 4
            and bool((rgba[..., 3] == 0).any())):
        rgba = _cleanup_transparent_area(rgba)

    _progress(config, 0)
    if config.lossless:
        out = _encode_lossless(rgba, config, stats, dev)
    else:
        out = encode_vp8_webp(rgba, config, stats=stats, device=dev)
    if stats is not None:
        stats.coded_size = len(out)
    _progress(config, 100)
    return out


def _encode_lossless(rgba: np.ndarray, config: EncoderConfig, stats,
                     dev) -> bytes:
    """The VP8L file of ``rgba`` (near-lossless preprocessing first)."""
    from .constants import CHUNK_VP8L
    from .container.riff import Chunk, assemble_simple
    from .models.vp8l.encoder import encode_vp8l

    if config.near_lossless < 100:
        from .models.vp8l.near_lossless import apply_near_lossless

        if rgba.shape[2] == 3:
            rgba = np.concatenate(
                [rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)],
                axis=-1)
        rgba = apply_near_lossless(rgba, config.near_lossless)
    payload = encode_vp8l(rgba, quality=int(config.quality),
                          method=config.method, stats=stats,
                          hint=int(config.image_hint), device=dev)
    if stats is not None:
        stats.lossless_size = len(payload)
    return assemble_simple(Chunk(CHUNK_VP8L, payload))


def encode_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray, *,
               alpha: np.ndarray | None = None, quality: float = 75.0,
               method: int = 4, config: EncoderConfig | None = None,
               stats=None, device=None) -> bytes:
    """Encode YUV420 planes into a lossy .webp byte string.

    y is (H, W); u and v are (ceil(H/2), ceil(W/2)); alpha, if given, is
    (H, W) and produces an ALPH chunk in a VP8X container.  The planes go
    straight to the VP8 coder (``encode_vp8_frame``, the host encoder's
    decisions), whatever ``config.plane_backend`` says, as in the
    reference.  ``device`` as in ``encode_rgba``.
    """
    from .constants import CHUNK_ALPHA, CHUNK_VP8
    from .container.riff import Chunk, assemble, assemble_simple, build_vp8x
    from .device import resolve_device
    from .models.vp8.alpha import encode_alpha
    from .models.vp8.encoder import _pad_to_mb, encode_vp8_frame

    dev = resolve_device(device)
    if config is None:
        config = EncoderConfig(lossless=False, quality=quality, method=method)
    config.validate()
    y = np.asarray(y)
    u = np.asarray(u)
    v = np.asarray(v)
    if y.dtype != np.uint8 or u.dtype != np.uint8 or v.dtype != np.uint8:
        raise EncodeError("expected uint8 planes")
    h, w = y.shape
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if u.shape != (ch, cw) or v.shape != (ch, cw):
        raise EncodeError("u/v planes must be (ceil(H/2), ceil(W/2))")

    _progress(config, 0)
    payload = encode_vp8_frame(_pad_to_mb(y, 16), _pad_to_mb(u, 8),
                               _pad_to_mb(v, 8), w, h, config, stats=stats,
                               device=dev)
    if alpha is None:
        out = assemble_simple(Chunk(CHUNK_VP8, payload))
    else:
        alpha = np.asarray(alpha)
        if alpha.shape != (h, w):
            raise EncodeError("alpha plane must match luma shape")
        alpha_payload = encode_alpha(
            alpha,
            method=config.alpha_compression,
            quality=config.alpha_quality,
            filtering_level=config.alpha_filtering,
        )
        out = assemble([
            build_vp8x(w, h, has_alpha=True),
            Chunk(CHUNK_ALPHA, alpha_payload),
            Chunk(CHUNK_VP8, payload),
        ])
    if stats is not None:
        stats.coded_size = len(out)
    _progress(config, 100)
    return out


def encode_rgba_batch(images: list, *, quality: float = 75.0,
                      threads: int = 0, device=None,
                      engine: str = "hybrid",
                      timings: dict | None = None) -> list:
    """Lossy-encode a batch of same-shaped (H, W, 3|4) uint8 images.

    Runs the pipelined batch encoder (ops/encode_pipeline.py, chunks of
    up to 16 images, 3 in flight) with the default config at ``quality``
    and the dense engine ``engine`` names: "hybrid" (default: segmentation, i4
    mode search, per-segment quantizers, exact closed-loop coding),
    "wavefront" (the same, with every mode searched inside the closed
    loop: the host encoder's decisions, one full-search kernel launch a
    chunk) or "openloop" (fastest, lower quality: one quantizer, i16
    modes from the source planes, prediction drift).  Token emission is
    native.
    ``device`` None means CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` to run the kernels' plain versions (identical
    bytes).  A batch of mixed shapes or channel counts is encoded as the
    reference encodes it: image by image through ``encode_rgba`` at
    ``quality`` (the host encoder's decisions, an ALPH chunk for a
    non-opaque image), whatever ``engine`` says.  Returns one .webp byte
    string per image, in input order.  ``timings``, if given, gathers the
    pipeline's spans, stage milliseconds and host seconds
    (``encode_rgba_batch_pipelined``); a mixed batch records none.
    """
    from .device import resolve_device
    from .ops.encode_pipeline import check_engine, encode_rgba_batch_pipelined

    check_engine(engine)
    if not images:
        return []
    dev = resolve_device(device)
    arrays = [np.asarray(im) for im in images]
    for a in arrays:
        if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
            raise EncodeError("expected (H, W, 3|4) uint8 images")
    if any(a.shape != arrays[0].shape for a in arrays):
        config = EncoderConfig(lossless=False, quality=quality)
        return [encode_rgba(a, config=config, device=dev) for a in arrays]
    return encode_rgba_batch_pipelined(
        arrays, quality=quality,
        threads=(threads if threads > 0 else min(8, len(arrays))),
        chunk=min(16, len(arrays)), device=dev, engine=engine,
        timings=timings)


def _cleanup_transparent_area(rgba: np.ndarray) -> np.ndarray:
    """Flatten RGB under fully-transparent pixels for compressibility
    (libwebp's WebPCleanupTransparentArea): unless ``exact`` is set,
    invisible pixels are free — per 16x16 block, partially-transparent
    blocks replace invisible RGB with the block's visible average;
    fully-transparent blocks repeat the previous flat colour so that
    runs compress to nothing."""
    out = rgba.copy()
    h, w = rgba.shape[:2]
    alpha = rgba[..., 3]
    flat = np.zeros(3, np.uint8)
    for by in range(0, h, 16):
        for bx in range(0, w, 16):
            a = alpha[by : by + 16, bx : bx + 16]
            vis = a > 0
            n_vis = int(vis.sum())
            blk = out[by : by + 16, bx : bx + 16, :3]
            if n_vis == 0:
                blk[:] = flat
            elif n_vis < a.size:
                mean = blk[vis].mean(axis=0).astype(np.uint8)
                blk[~vis] = mean
                flat = mean
            else:
                flat = blk[-1, -1]
    return out


def _progress(config: EncoderConfig, percent: int) -> None:
    hook = getattr(config, "progress_hook", None)
    if hook is not None and hook(percent) is False:
        raise EncodeError("encoding aborted by progress hook")


__all__ = ["encode_rgba", "encode_rgba_batch", "encode_yuv"]
