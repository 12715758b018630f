"""Top-level batch encode API of the PyTorch port."""

from __future__ import annotations

import numpy as np

from .errors import EncodeError


def encode_rgba_batch(images: list, *, quality: float = 75.0,
                      threads: int = 0, device=None,
                      engine: str = "hybrid") -> list:
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
    bytes).  A batch of mixed shapes raises.  Returns one .webp byte
    string per image.
    """
    from .device import resolve_device
    from .ops.encode_pipeline import check_engine, encode_rgba_batch_pipelined

    check_engine(engine)
    if not images:
        return []
    dev = resolve_device(device)
    arrays = [np.asarray(im) for im in images]
    shape = arrays[0].shape
    for a in arrays:
        if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
            raise EncodeError("expected (H, W, 3|4) uint8 images")
        if a.shape != shape:
            raise EncodeError("all images of a batch must share one shape")
    return encode_rgba_batch_pipelined(
        arrays, quality=quality,
        threads=(threads if threads > 0 else min(8, len(arrays))),
        chunk=min(16, len(arrays)), device=dev, engine=engine)


__all__ = ["encode_rgba_batch"]
