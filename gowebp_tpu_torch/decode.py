"""Top-level batch decode API of the PyTorch port: .webp files → RGBA.

Every still WebP kind is taken: lossy (VP8), lossy with an ALPH chunk,
and lossless (VP8L), in any mix.  Per call:

  1. host: the container parse routes each file, before any other work
     (a file with neither a VP8 nor a VP8L chunk raises);
  2. host, in a thread pool (the native engines release the GIL): the
     interleaved symbol engine turns up to 32 lossy images per thread
     into dequantized (N, 24, 16) int16 coefficients, (N, 21) modes and
     per-MB filter parameters, and the same thread decodes each image's
     ALPH plane; each VP8L file is decoded whole on the host
     (models/vp8l), as a task of the same pool;
  3. the lossy images of each thread are grouped by (width, height,
     filter_type, has_alpha);
  4. one h2d copy per group of one host buffer holding its dense
     coefficients, modes and filter parameters and, for an ALPH group,
     its (B, H, W) alpha planes;
  5. device: residual iDCT, the intra-reconstruction wavefront and the
     loop-filter wavefront (ops/vp8_recon.py), then the fused fancy
     upsample + YUV→RGBA kernel (ops/kernels/yuv420_to_rgba), which
     reads the MB-padded planes and, for an ALPH group, the alpha
     planes, and writes the cropped RGBA;
  6. one d2h copy per group, unless ``device_out=True``; then the
     host-decoded images (VP8L, and every image with
     ``recon_backend="host"``) go up in one h2d copy per shape instead.

``recon_backend="host"`` runs steps 4-5 on the host too: the native
recon and loop filter, the native fancy upsampler and the alpha plane
(models/vp8/decoder.py ``recon_vp8_yuv_host``, ``yuv_planes_to_rgba``).

Output pixels are identical on every device and either backend: the
device only routes the last stage to the CUDA kernel or to its plain
torch version.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import torch

from .constants import CHUNK_ALPHA, CHUNK_VP8, CHUNK_VP8L
from .container.riff import parse_riff
from .device import StageClock, resolve_device
from .errors import BitstreamError
from .models.vp8.alpha import decode_alpha
from .models.vp8.decoder import (decode_vp8_symbols_batch, recon_vp8_yuv_host,
                                 vp8_filter_params, yuv_planes_to_rgba)
from .models.vp8l.decoder import decode_vp8l
from .ops.kernels.yuv420_to_rgba import yuv420_to_rgba
from .ops.vp8_recon import recon_frame

STREAMS_PER_ENGINE = 32   # images per symbol-engine call (its lanes)
RECON_BACKENDS = ("device", "host")


def _route(data: bytes):
    """("vp8", VP8 payload, ALPH payload or None) or ("vp8l", VP8L
    payload, None); a file with neither chunk raises."""
    parsed = parse_riff(data)
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is not None:
        alpha = parsed.find(CHUNK_ALPHA)
        return "vp8", vp8.payload, None if alpha is None else alpha.payload
    vp8l = parsed.find(CHUNK_VP8L)
    if vp8l is not None:
        return "vp8l", vp8l.payload, None
    raise BitstreamError("no decodable image chunk found")


def _upload(recs, dev):
    """One host buffer per group: per image, its int16 coefficients, its
    uint8 modes (padded to 4 bytes) and its int16 filter parameters;
    then, 16-byte aligned, the group's (B, H, W) alpha planes if it has
    them; one h2d copy; device views of the four (alpha None without)."""
    B = len(recs)
    st = recs[0][1]
    N = recs[0][2].shape[0]
    lc, lm, lf = N * 24 * 16 * 2, N * 21, N * 4 * 2
    lm4 = (lm + 3) // 4 * 4
    rec = lc + lm4 + lf
    head = (B * rec + 15) // 16 * 16
    has_alpha = recs[0][5] is not None
    la = st.height * st.width if has_alpha else 0
    buf = np.empty(head + B * la, np.uint8)
    body = buf[:B * rec].reshape(B, rec)
    planes = buf[head:].reshape(B, la)
    for k, (_, _, coeffs, modes, fp, alpha) in enumerate(recs):
        body[k, :lc] = coeffs.reshape(-1).view(np.uint8)
        body[k, lc:lc + lm] = modes.reshape(-1)
        body[k, lc + lm4:] = fp.astype(np.int16).reshape(-1).view(np.uint8)
        if has_alpha:
            planes[k] = alpha.reshape(-1)
    d = torch.from_numpy(buf).to(dev)
    dbody = d[:B * rec].view(B, rec)
    coeffs = dbody[:, :lc].view(torch.int16).reshape(B, N, 24, 16)
    modes = dbody[:, lc:lc + lm].reshape(B, N, 21)
    fp = dbody[:, lc + lm4:].view(torch.int16).reshape(B, N, 4)
    alpha = (d[head:].view(B, st.height, st.width) if has_alpha else None)
    return coeffs, modes, fp, alpha


def _decode_group(recs, dev, device_out: bool, timings):
    """Device phases of one (width, height, filter_type, has_alpha) group
    → (B, H, W, 4) uint8 RGBA, on the device or as a NumPy array."""
    st = recs[0][1]
    clock = StageClock(dev) if timings is not None else None

    def mark(name):
        if clock is not None:
            clock(name)

    coeffs, modes, fp, alpha = _upload(recs, dev)
    mark("h2d")
    Y, U, V = recon_frame(
        coeffs, modes[:, :, 0], modes[:, :, 5:21], modes[:, :, 1],
        fp.reshape(len(recs), st.mb_h, st.mb_w, 4), mb_w=st.mb_w,
        mb_h=st.mb_h, filter_type=st.filter_type, marks=mark)
    rgba = yuv420_to_rgba(Y, U, V, st.height, st.width, alpha)
    mark("yuv420_to_rgba")
    if not device_out:
        rgba = rgba.cpu().numpy()
        mark("d2h")
    if clock is not None:
        _add_spans(timings, clock)
    return rgba


def _add_spans(timings, clock) -> None:
    stage = timings.setdefault("stage_ms", {})
    for k, ms in clock.spans_ms().items():
        stage[k] = stage.get(k, 0.0) + ms


def _upload_host_images(items, results, dev, timings) -> None:
    """``device_out``: the host-decoded (index, RGBA) images go up in one
    h2d copy per shape; each result is a view of its batch."""
    clock = StageClock(dev) if timings is not None else None
    by_shape = {}
    for i, rgba in items:
        by_shape.setdefault(rgba.shape, []).append((i, rgba))
    for group in by_shape.values():
        batch = torch.from_numpy(np.stack([r for _, r in group])).to(dev)
        for k, (i, _) in enumerate(group):
            results[i] = batch[k]
    if clock is not None:
        clock("h2d_host_rgba")
        _add_spans(timings, clock)


def decode_rgba_batch(datas: list, *, threads: int = 0, device=None,
                      device_out: bool = False, recon_backend: str = "device",
                      timings: dict | None = None) -> list:
    """Decode many still .webp files (lossy, lossy + ALPH, lossless, in
    any mix) to (H, W, 4) uint8 RGBA, in input order.

    ``device`` None means CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` to run the kernel's plain torch version (identical
    pixels).  ``recon_backend="device"`` reconstructs lossy images on
    ``device``; ``"host"`` reconstructs and converts them on the host
    with the native layer (identical pixels).  Results are NumPy arrays,
    or with ``device_out=True`` uint8 tensors on ``device``.  A file with
    no VP8 or VP8L chunk raises BitstreamError before any work.
    ``timings``, if given, gathers per-stage milliseconds under
    "stage_ms" (CUDA-event spans on the card) and host thread seconds:
    "symbols_s" (the symbol engine), "alpha_s" (ALPH planes), "vp8l_s"
    (VP8L files) and, with the host backend, "recon_host_s".
    """
    dev = resolve_device(device)
    if recon_backend not in RECON_BACKENDS:
        raise ValueError(f"recon_backend must be one of {RECON_BACKENDS}, "
                         f"got {recon_backend!r}")
    routed = [_route(d) for d in datas]
    if not routed:
        return []
    lossy = [(i, p, a) for i, (kind, p, a) in enumerate(routed)
             if kind == "vp8"]
    lossless = [(i, p) for i, (kind, p, _) in enumerate(routed)
                if kind == "vp8l"]
    on_host = recon_backend == "host"
    secs = {"symbols_s": 0.0, "alpha_s": 0.0, "vp8l_s": 0.0}
    if on_host:
        secs["recon_host_s"] = 0.0
    workers = threads if threads > 0 else min(8, len(datas))
    ng = min(workers, -(-len(lossy) // STREAMS_PER_ENGINE))
    groups = [lossy[g::ng] for g in range(ng)]

    def symbols(items):
        """Symbol phase of one group, with its ALPH planes; on the host
        backend also recon, conversion and the alpha merge."""
        t0 = time.perf_counter()
        syms = decode_vp8_symbols_batch([p for _, p, _ in items])
        took = {"symbols_s": time.perf_counter() - t0, "alpha_s": 0.0,
                "recon_host_s": 0.0}
        out = []
        for (i, _, ap), (st, coeffs, modes) in zip(items, syms):
            t0 = time.perf_counter()
            plane = (None if ap is None
                     else decode_alpha(ap, st.width, st.height))
            t1 = time.perf_counter()
            took["alpha_s"] += t1 - t0
            if on_host:
                rgba = yuv_planes_to_rgba(*recon_vp8_yuv_host(st, coeffs,
                                                              modes))
                if plane is not None:
                    rgba[..., 3] = plane
                out.append((i, rgba))
                took["recon_host_s"] += time.perf_counter() - t1
            else:
                out.append((i, st, coeffs, modes,
                            vp8_filter_params(st, modes), plane))
                took["symbols_s"] += time.perf_counter() - t1
        return out, took

    def lossless_one(item):
        i, payload = item
        t0 = time.perf_counter()
        rgba = decode_vp8l(payload)
        return [(i, rgba)], {"vp8l_s": time.perf_counter() - t0}

    results = [None] * len(datas)
    host_images = []

    def device_phase(recs):
        by_shape = {}
        for rec in recs:
            st = rec[1]
            key = (st.width, st.height, st.filter_type, rec[5] is not None)
            by_shape.setdefault(key, []).append(rec)
        for grp in by_shape.values():
            rgba = _decode_group(grp, dev, device_out, timings)
            for k, rec in enumerate(grp):
                results[rec[0]] = rgba[k]

    def finish(out, took, lossy_group: bool):
        for k, s in took.items():
            if k in secs:
                secs[k] += s
        if lossy_group and not on_host:
            device_phase(out)
        else:
            host_images.extend(out)

    if workers <= 1 or (ng <= 1 and not lossless):
        for g in groups:
            finish(*symbols(g), True)
        for item in lossless:
            finish(*lossless_one(item), False)
    else:
        # a group's device phase overlaps the later groups' symbol phases
        # and the VP8L decodes
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            lossy_futs = [pool.submit(symbols, g) for g in groups]
            lossless_futs = [pool.submit(lossless_one, it) for it in lossless]
            for fut in lossy_futs:
                finish(*fut.result(), True)
            for fut in lossless_futs:
                finish(*fut.result(), False)

    if device_out and host_images:
        _upload_host_images(host_images, results, dev, timings)
    else:
        for i, rgba in host_images:
            results[i] = rgba
    if timings is not None:
        for k, s in secs.items():
            timings[k] = timings.get(k, 0.0) + s
    return results


__all__ = ["decode_rgba_batch"]
