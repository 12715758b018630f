"""Top-level batch decode API of the PyTorch port: .webp files → RGBA.

Per call:

  1. host, in a thread pool (the native symbol engines release the
     GIL): container parse, frame header, then the interleaved symbol
     engine turns up to 32 images per thread into dequantized (N, 24, 16)
     int16 coefficients, (N, 21) modes and per-MB filter parameters;
  2. the images of each thread are grouped by (width, height,
     filter_type);
  3. one h2d copy per group of one host buffer holding its dense
     coefficients, modes and filter parameters;
  4. device: residual iDCT, the intra-reconstruction wavefront and the
     loop-filter wavefront (ops/vp8_recon.py), then the fused fancy
     upsample + YUV→RGBA kernel (ops/kernels/yuv420_to_rgba), which
     reads the MB-padded planes and writes the cropped RGBA;
  5. one d2h copy per group, unless ``device_out=True``.

Output pixels are identical on every device: the device only routes the
last stage to the CUDA kernel or to its plain torch version.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import torch

from .constants import CHUNK_ALPHA, CHUNK_VP8, CHUNK_VP8L
from .container.riff import parse_riff
from .device import StageClock, resolve_device
from .errors import BitstreamError, UnsupportedFeature
from .models.vp8.decoder import decode_vp8_symbols_batch, vp8_filter_params
from .ops.kernels.yuv420_to_rgba import yuv420_to_rgba
from .ops.vp8_recon import recon_frame

STREAMS_PER_ENGINE = 32   # images per symbol-engine call (its lanes)


def _vp8_payload(data: bytes) -> bytes:
    """The VP8 chunk of a lossy file; other kinds raise before any work."""
    parsed = parse_riff(data)
    if parsed.find(CHUNK_VP8L) is not None:
        raise UnsupportedFeature(
            "VP8L (lossless) files are not decoded by the port yet")
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is None:
        raise BitstreamError("no decodable image chunk found")
    if parsed.find(CHUNK_ALPHA) is not None:
        raise UnsupportedFeature(
            "lossy files with an ALPH chunk are not decoded by the port yet")
    return vp8.payload


def _upload(recs, dev):
    """One host buffer per group: per image, its int16 coefficients, its
    uint8 modes (padded to 4 bytes) and its int16 filter parameters;
    one h2d copy; device views of the three."""
    B = len(recs)
    N = recs[0][2].shape[0]
    lc, lm, lf = N * 24 * 16 * 2, N * 21, N * 4 * 2
    lm4 = (lm + 3) // 4 * 4
    buf = np.empty((B, lc + lm4 + lf), np.uint8)
    for k, (_, _, coeffs, modes, fp) in enumerate(recs):
        buf[k, :lc] = coeffs.reshape(-1).view(np.uint8)
        buf[k, lc:lc + lm] = modes.reshape(-1)
        buf[k, lc + lm4:] = fp.astype(np.int16).reshape(-1).view(np.uint8)
    d = torch.from_numpy(buf).to(dev)
    coeffs = d[:, :lc].view(torch.int16).reshape(B, N, 24, 16)
    modes = d[:, lc:lc + lm].reshape(B, N, 21)
    fp = d[:, lc + lm4:].view(torch.int16).reshape(B, N, 4)
    return coeffs, modes, fp


def _decode_group(recs, dev, device_out: bool, timings):
    """Device phases of one (width, height, filter_type) group →
    (B, H, W, 4) uint8 RGBA, on the device or as a NumPy array."""
    st = recs[0][1]
    clock = StageClock(dev) if timings is not None else None

    def mark(name):
        if clock is not None:
            clock(name)

    coeffs, modes, fp = _upload(recs, dev)
    mark("h2d")
    Y, U, V = recon_frame(
        coeffs, modes[:, :, 0], modes[:, :, 5:21], modes[:, :, 1],
        fp.reshape(len(recs), st.mb_h, st.mb_w, 4), mb_w=st.mb_w,
        mb_h=st.mb_h, filter_type=st.filter_type, marks=mark)
    rgba = yuv420_to_rgba(Y, U, V, st.height, st.width)
    mark("yuv420_to_rgba")
    if not device_out:
        rgba = rgba.cpu().numpy()
        mark("d2h")
    if clock is not None:
        stage = timings.setdefault("stage_ms", {})
        for k, ms in clock.spans_ms().items():
            stage[k] = stage.get(k, 0.0) + ms
    return rgba


def decode_rgba_batch(datas: list, *, threads: int = 0, device=None,
                      device_out: bool = False, timings: dict | None = None
                      ) -> list:
    """Decode many lossy .webp files to (H, W, 4) uint8 RGBA.

    ``device`` None means CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` to run the kernel's plain torch version (identical
    pixels).  Results are NumPy arrays, or with ``device_out=True``
    uint8 tensors that stay on the device.  VP8L files and files with an
    ALPH chunk raise UnsupportedFeature.  ``timings``, if given, gathers
    per-stage milliseconds under "stage_ms" (CUDA-event spans on the
    card) and the host symbol phase's thread seconds under "symbols_s".
    """
    dev = resolve_device(device)
    payloads = [_vp8_payload(d) for d in datas]
    if not payloads:
        return []
    if timings is not None:
        timings.setdefault("symbols_s", 0.0)
    workers = threads if threads > 0 else min(8, len(payloads))
    ng = min(workers, -(-len(payloads) // STREAMS_PER_ENGINE))
    groups = [list(range(g, len(payloads), ng)) for g in range(ng)]

    def symbols(idx):
        t0 = time.perf_counter()
        syms = decode_vp8_symbols_batch([payloads[i] for i in idx])
        recs = [(i, st, coeffs, modes, vp8_filter_params(st, modes))
                for i, (st, coeffs, modes) in zip(idx, syms)]
        return recs, time.perf_counter() - t0

    results = [None] * len(payloads)

    def device_phase(recs, secs):
        if timings is not None:
            timings["symbols_s"] += secs
        by_shape = {}
        for rec in recs:
            st = rec[1]
            by_shape.setdefault((st.width, st.height, st.filter_type),
                                []).append(rec)
        for grp in by_shape.values():
            rgba = _decode_group(grp, dev, device_out, timings)
            for k, rec in enumerate(grp):
                results[rec[0]] = rgba[k]

    if ng == 1:
        device_phase(*symbols(groups[0]))
    else:
        # a group's device phase overlaps the later groups' symbol phases
        with cf.ThreadPoolExecutor(max_workers=ng) as pool:
            for fut in [pool.submit(symbols, g) for g in groups]:
                device_phase(*fut.result())
    return results


__all__ = ["decode_rgba_batch"]
