"""Top-level batch encode API of the PyTorch port."""

from __future__ import annotations

import numpy as np

from .errors import EncodeError, UnsupportedFeature


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
    bytes).  A batch of mixed shapes or channel counts is encoded as the
    reference encodes it, image by image with the host encoder, when every
    image is opaque (3 channels, or alpha all 255): one
    ``engine="wavefront"`` call per shape, whose decisions are the host
    encoder's, whatever ``engine`` says.  A mixed batch with a non-opaque
    image raises UnsupportedFeature: its ALPH chunk needs the single-image
    encode, which the port does not have yet.  Returns one .webp byte
    string per image, in input order.
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

    def run(batch, eng):
        return encode_rgba_batch_pipelined(
            batch, quality=quality,
            threads=(threads if threads > 0 else min(8, len(batch))),
            chunk=min(16, len(batch)), device=dev, engine=eng)

    groups = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.shape, []).append(i)
    if len(groups) == 1:
        return run(arrays, engine)
    if any(a.shape[2] == 4 and not (a[..., 3] == 255).all() for a in arrays):
        raise UnsupportedFeature(
            "a batch of mixed shapes with a non-opaque RGBA image needs the "
            "single-image encode (ROADMAP Queue 1, single-image encode), "
            "which the port does not have yet")
    out = [None] * len(arrays)
    for idx in groups.values():
        for i, data in zip(idx, run([arrays[i] for i in idx], "wavefront")):
            out[i] = data
    return out


__all__ = ["encode_rgba_batch"]
