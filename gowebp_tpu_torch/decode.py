"""Top-level decode API of the PyTorch port: .webp files → pixels.

The single-file calls (``decode`` with every output mode, ``decode_rgba``,
``decode_rgb``, ``decode_into``, ``decode_yuv``, ``decode_yuva``,
``features``) take a ``DecoderConfig`` as libwebp's WebPDecode does.  A
lossy file goes: host container parse, the single-stream symbol engine
and the ALPH plane, one h2d copy (``_upload``), the recon and loop-filter
kernels (ops/vp8_recon.py), the chroma dither (drawn on the host, added
on the device), ``yuv420_to_rgba`` (fancy or nearest upsampling, with
alpha), the output options and mode conversion as torch ops on the
device, and one d2h copy of the final array.  A lossless file decodes on
the host (models/vp8l) and its options run on that CPU tensor.

The batch call ``decode_rgba_batch`` takes every still WebP kind: lossy
(VP8), lossy with an ALPH chunk, and lossless (VP8L), in any mix.  Per
call:

  1. host: the container parse routes each file, before any other work
     (a file with neither a VP8 nor a VP8L chunk raises);
  2. host, in a thread pool (the native engines release the GIL): the
     interleaved symbol engine turns up to 32 lossy images per thread
     into dequantized (N, 24, 16) int16 coefficients, (N, 21) modes and
     per-MB filter parameters, and the same thread decodes each image's
     ALPH plane; each VP8L file is decoded whole on the host
     (models/vp8l), as a task of the same pool;
  3. the same thread groups its lossy images by (width, height,
     filter_type, has_alpha) and packs each group's coefficients into
     the sparse wire layout (ops/coeff_pack.py: int8 levels, the i16 DC
     plane, tail and exception rows, the quantizers);
  4. one h2d copy per group of one host buffer holding its packed
     coefficients, modes and filter parameters and, for an ALPH group,
     its (B, H, W) alpha planes;
  5. device: the ``unpack_coeffs`` kernel (ops/kernels/coeff_unpack)
     turns the packed layout back into the dense int16 coefficients, the
     ``recon_filter_mb`` kernel (ops/vp8_recon.py, ops/kernels/vp8_recon)
     runs the residual iDCT, intra prediction and loop filter over the
     MB wavefront, then the fused fancy upsample + YUV→RGBA kernel
     (ops/kernels/yuv420_to_rgba) reads the MB-padded planes and, for an
     ALPH group, the alpha planes, and writes the cropped RGBA;
  6. one d2h copy per group, unless ``device_out=True``; then the
     host-decoded images (VP8L, and every image with
     ``recon_backend="host"``) go up in one h2d copy per shape instead.

The single-file calls upload the dense coefficients (``_upload``) and
skip the pack and the unpack.
``recon_backend="host"`` runs steps 3-5 on the host instead: the native
recon and loop filter, the native fancy upsampler and the alpha plane
(models/vp8/decoder.py ``recon_vp8_yuv_host``, ``yuv_planes_to_rgba``).

Output pixels are identical on every device and either backend: the
device only routes the last stage to the CUDA kernel or to its plain
torch version.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from .constants import CHUNK_ALPHA, CHUNK_VP8, CHUNK_VP8L
from .container.riff import WebPFeatures, get_features, parse_riff
from .decode_options import DecoderConfig, _rescale, apply_output_options
from . import tracing
from .device import resolve_device
from .errors import BitstreamError
from .models.vp8.alpha import decode_alpha
from .models.vp8.decoder import (decode_vp8_symbols, decode_vp8_symbols_batch,
                                 dither_deltas, recon_vp8_yuv_host,
                                 vp8_filter_params, yuv_planes_to_rgba)
from .models.vp8l.decoder import decode_vp8l
from .ops.coeff_pack import pack_images
from .ops.kernels.coeff_unpack import unpack_coeffs
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


_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32}


def _one_copy(parts, dev):
    """Parts given as (dtype, shape, fill): one host buffer holding each
    part 16-byte aligned, ``fill(view)`` writing each into its place; one
    h2d copy → (device views of the parts, the buffer's bytes)."""
    sizes = [np.dtype(dt).itemsize * int(np.prod(shape))
             for dt, shape, _ in parts]
    offs = [0]
    for n in sizes:
        offs.append((offs[-1] + n + 15) // 16 * 16)
    buf = np.empty(offs[-1], np.uint8)
    for (dt, shape, fill), o, n in zip(parts, offs, sizes):
        fill(buf[o:o + n].view(dt).reshape(shape))
    dbuf = torch.from_numpy(buf).to(dev)
    return [dbuf[o:o + n].view(_TORCH_DTYPES[np.dtype(dt)]).reshape(shape)
            for (dt, shape, _), o, n in zip(parts, offs, sizes)], buf.nbytes


def _stacked(arrays):
    """A fill that writes ``arrays`` one per batch index."""
    def fill(view):
        for k, a in enumerate(arrays):
            view[k] = a
    return fill


def _group_parts(recs):
    """The modes, filter parameters and (ALPH group) alpha planes of a
    group, as ``_one_copy`` parts."""
    B, st, N = len(recs), recs[0][1], recs[0][2].shape[0]
    parts = [(np.uint8, (B, N, 21), _stacked([r[3] for r in recs])),
             (np.int16, (B, N, 4),
              _stacked([r[4].reshape(N, 4) for r in recs]))]
    if recs[0][5] is not None:
        parts.append((np.uint8, (B, st.height, st.width),
                      _stacked([r[5] for r in recs])))
    return parts


def _upload(recs, dev):
    """The dense upload (the single-file calls): one host buffer per group
    with the group's int16 coefficients, its uint8 modes, its int16
    filter parameters and, for an ALPH group, its (B, H, W) alpha planes,
    each batch-contiguous and 16-byte aligned; one h2d copy; device views
    of the four (alpha None without)."""
    B, N = len(recs), recs[0][2].shape[0]
    views, _ = _one_copy(
        [(np.int16, (B, N, 24, 16), _stacked([r[2] for r in recs]))]
        + _group_parts(recs), dev)
    return (*views[:3], views[3] if len(views) > 3 else None)


def _pack_group(recs, counts=None):
    """The sparse wire layout of one group's coefficients (on the symbol
    thread): (dict of numpy arrays, K); ``counts`` as ``pack_images``."""
    return pack_images([r[2] for r in recs], [r[3][:, 2] for r in recs],
                       [r[3][:, 0] for r in recs],
                       [r[1].quant_rows() for r in recs], counts)


def _upload_packed(recs, packed, dev):
    """One host buffer per group with its packed coefficients, modes,
    filter parameters and alpha planes; one h2d copy → (the packed dict
    on ``dev``, modes, fparams, alpha or None, the bytes copied)."""
    keys = list(packed)
    parts = [(packed[k].dtype, packed[k].shape,
              lambda v, a=packed[k]: np.copyto(v, a)) for k in keys]
    views, nbytes = _one_copy(parts + _group_parts(recs), dev)
    rest = views[len(keys):]
    return (dict(zip(keys, views)), rest[0], rest[1],
            rest[2] if len(rest) > 2 else None, nbytes)


def _decode_group(recs, packed, dev, device_out: bool, clock):
    """Device phases of one (width, height, filter_type, has_alpha) group
    from its packed coefficients → ((B, H, W, 4) uint8 RGBA, on the
    device or as a NumPy array; the bytes copied up)."""
    st = recs[0][1]

    def mark(name):
        if clock is not None:
            clock(name)

    wire, modes, fp, alpha, nbytes = _upload_packed(recs, packed, dev)
    mark("h2d")
    coeffs = unpack_coeffs(wire)
    mark("unpack")
    Y, U, V = recon_frame(
        coeffs, modes[:, :, 0], modes[:, :, 5:21], modes[:, :, 1],
        fp.reshape(len(recs), st.mb_h, st.mb_w, 4), mb_w=st.mb_w,
        mb_h=st.mb_h, filter_type=st.filter_type, marks=mark)
    rgba = yuv420_to_rgba(Y, U, V, st.height, st.width, alpha)
    mark("yuv420_to_rgba")
    if not device_out:
        rgba = rgba.cpu().numpy()
        mark("d2h")
    return rgba, nbytes


def _upload_host_images(items, results, dev, clock) -> None:
    """``device_out``: the host-decoded (index, RGBA) images go up in one
    h2d copy per shape; each result is a view of its batch."""
    by_shape = {}
    for i, rgba in items:
        by_shape.setdefault(rgba.shape, []).append((i, rgba))
    for group in by_shape.values():
        batch = torch.from_numpy(np.stack([r for _, r in group])).to(dev)
        for k, (i, _) in enumerate(group):
            results[i] = batch[k]
    if clock is not None:
        clock("h2d_host_rgba")


# span → ``timings`` key of its summed seconds, per recon backend
_SUMS = {"decode.symbols": "symbols_s", "decode.alpha": "alpha_s",
         "decode.vp8l": "vp8l_s"}
_SUMS_DEVICE = {**_SUMS, "decode.pack": "pack_s"}
_SUMS_HOST = {**_SUMS, "decode.recon_host": "recon_host_s"}


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

    ``timings``, if given, gathers the call's spans (tracing.py) under
    "spans"; per-stage milliseconds under "stage_ms" (CUDA-event spans on
    the card: h2d, unpack, recon, yuv420_to_rgba, d2h), resolved once, as
    the call ends; the bytes of the groups' copies under "h2d_bytes" and
    "d2h_bytes"; "kernels.loads"; and the host spans' summed seconds:
    "symbols_s" (the symbol engine), "alpha_s" (ALPH planes), "pack_s"
    (the coefficient pack), "vp8l_s" (VP8L files) and, with the host
    backend, "recon_host_s".  Under ``torch.profiler`` the spans go to
    ``tracing.recorded()``.
    """
    dev = resolve_device(device)
    if recon_backend not in RECON_BACKENDS:
        raise ValueError(f"recon_backend must be one of {RECON_BACKENDS}, "
                         f"got {recon_backend!r}")
    on_host = recon_backend == "host"
    rec = tracing.recorder("decode.call", timings,
                           _SUMS_HOST if on_host else _SUMS_DEVICE)
    routed = [_route(d) for d in datas]
    if not routed:
        return []
    lossy = [(i, p, a) for i, (kind, p, a) in enumerate(routed)
             if kind == "vp8"]
    lossless = [(i, p) for i, (kind, p, _) in enumerate(routed)
                if kind == "vp8l"]
    workers = threads if threads > 0 else min(8, len(datas))
    ng = min(workers, -(-len(lossy) // STREAMS_PER_ENGINE))
    groups = [lossy[g::ng] for g in range(ng)]

    def symbols(g):
        """Symbol phase of engine call ``g``, with its ALPH planes; on the
        device backend then the pack of each shape group, on the host
        backend recon, conversion and the alpha merge."""
        items = groups[g]
        sp = rec.begin("decode.symbols") if rec is not None else None
        syms = decode_vp8_symbols_batch([p for _, p, _ in items])
        fps = ([None] * len(syms) if on_host else
               [vp8_filter_params(st, modes) for st, _, modes in syms])
        if sp is not None:
            rec.end(sp, group=g, files=len(items),
                    bytes_in=sum(len(p) for _, p, _ in items))
        out = []
        for (i, _, ap), (st, coeffs, modes), fpar in zip(items, syms, fps):
            plane = None
            if ap is not None:
                sp = rec.begin("decode.alpha") if rec is not None else None
                plane = decode_alpha(ap, st.width, st.height)
                if sp is not None:
                    rec.end(sp, file=i)
            if on_host:
                sp = (rec.begin("decode.recon_host") if rec is not None
                      else None)
                rgba = yuv_planes_to_rgba(*recon_vp8_yuv_host(st, coeffs,
                                                              modes))
                if plane is not None:
                    rgba[..., 3] = plane
                out.append((i, rgba))
                if sp is not None:
                    rec.end(sp, file=i)
            else:
                out.append((i, st, coeffs, modes, fpar, plane))
        if on_host:
            return out
        sp = rec.begin("decode.pack") if rec is not None else None
        counts = None if sp is None else {}
        by_shape = {}
        for r in out:
            st = r[1]
            key = (st.width, st.height, st.filter_type, r[5] is not None)
            by_shape.setdefault(key, []).append(r)
        packed = [(grp, _pack_group(grp, counts)[0])
                  for grp in by_shape.values()]
        if sp is not None:
            rec.end(sp, group=g, shapes=len(packed), **counts)
        return packed

    def lossless_one(item):
        i, payload = item
        sp = rec.begin("decode.vp8l") if rec is not None else None
        rgba = decode_vp8l(payload)
        if sp is not None:
            rec.end(sp, file=i)
        return [(i, rgba)]

    results = [None] * len(datas)
    host_images = []

    def device_phase(g, out):
        """Group ``g``'s shape groups through the device, on the calling
        thread."""
        for grp, packed in out:
            sp = rec.begin("decode.device") if rec is not None else None
            clock = rec.clock(dev) if rec is not None else None
            rgba, nbytes = _decode_group(grp, packed, dev, device_out, clock)
            for k, r in enumerate(grp):
                results[r[0]] = rgba[k]
            if sp is not None:
                rec.end(sp, group=g, files=len(grp), h2d_bytes=nbytes,
                        d2h_bytes=0 if device_out else rgba.nbytes)

    def finish(g, out):
        if g is not None and not on_host:
            device_phase(g, out)
        else:
            host_images.extend(out)

    if workers <= 1 or (ng <= 1 and not lossless):
        for g in range(ng):
            finish(g, symbols(g))
        for item in lossless:
            finish(None, lossless_one(item))
    else:
        # a group's device phase overlaps the later groups' symbol phases
        # and the VP8L decodes
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futs = ([(g, pool.submit(symbols, g)) for g in range(ng)]
                    + [(None, pool.submit(lossless_one, it))
                       for it in lossless])
            for g, fut in futs:
                sp = rec.begin("decode.wait") if rec is not None else None
                out = fut.result()
                if sp is not None:
                    rec.end(sp, group=-1 if g is None else g)
                finish(g, out)

    if device_out and host_images:
        _upload_host_images(host_images, results, dev,
                            rec.clock(dev) if rec is not None else None)
    else:
        for i, rgba in host_images:
            results[i] = rgba
    if rec is not None:
        rec.finish(files=len(datas), groups=ng)
    return results


# ---------------------------------------------------------------------------
# Single-file decode
# ---------------------------------------------------------------------------

_MODE_PERMUTE = {
    "RGBA": (0, 1, 2, 3),
    "BGRA": (2, 1, 0, 3),
    "ARGB": (3, 0, 1, 2),
    "RGB": (0, 1, 2),
    "BGR": (2, 1, 0),
}
# Premultiplied variants share the channel orders; the premultiply runs
# first.
_MODE_PREMULT = {"rgbA": "RGBA", "bgrA": "BGRA", "Argb": "ARGB",
                 "rgbA_4444": "RGBA_4444"}
_MODE_PACKED = ("RGB_565", "RGBA_4444")
_MODE_CHANNELS = {"RGBA": 4, "BGRA": 4, "ARGB": 4, "RGB": 3, "BGR": 3,
                  "rgbA": 4, "bgrA": 4, "Argb": 4,
                  "RGB_565": 2, "RGBA_4444": 2, "rgbA_4444": 2}
ALPHA_DITHER_SEED = 0xA1FA


def _premultiply(rgba):
    """8-bit approximate premultiply, libwebp's (c * a * 32897) >> 23."""
    a = rgba[..., 3:].to(torch.int64)
    rgb = (rgba[..., :3].to(torch.int64) * a * 32897) >> 23
    return torch.cat([rgb.to(torch.uint8), rgba[..., 3:]], dim=-1)


def _pack_16bit(rgba, mode: str):
    """(H, W, 4) → (H, W, 2) uint8 packed rows in libwebp's MODE_RGB_565 /
    MODE_RGBA_4444 byte order."""
    r, g, b, a = (rgba[..., c].to(torch.int32) for c in range(4))
    if mode == "RGB_565":
        hi, lo = (r & 0xF8) | (g >> 5), ((g << 3) & 0xE0) | (b >> 3)
    else:
        hi, lo = (r & 0xF0) | (g >> 4), (b & 0xF0) | (a >> 4)
    return torch.stack([hi, lo], dim=-1).to(torch.uint8)


def _alpha_dither(rgba, strength: int):
    """libwebp's alpha_dithering_strength: a triangular dither of the
    alpha plane, drawn on the host from numpy's generator seeded with
    ALPHA_DITHER_SEED and added where the pixels are."""
    if (strength <= 0 or rgba.shape[2] != 4
            or not bool((rgba[..., 3] != 255).any())):
        return rgba
    amp = 8 * strength // 100
    if amp <= 0:
        return rgba
    rng = np.random.default_rng(ALPHA_DITHER_SEED)
    sh = tuple(rgba.shape[:2])
    noise = (rng.integers(0, amp + 1, sh) + rng.integers(0, amp + 1, sh)
             - amp)
    half = torch.from_numpy((noise // 2).astype(np.int16)).to(rgba.device)
    out = rgba.clone()
    out[..., 3] = (rgba[..., 3].to(torch.int16) + half).clamp(0, 255)
    return out


def _vp8_planes(payload: bytes, alpha_payload, config: DecoderConfig, dev,
                filter_level_override: int | None = None):
    """One lossy frame on ``dev`` → its MB-padded (1, Hy, Wy) Y and
    (1, Hc, Wc) U, V planes, filtered and dithered; its (1, H, W) alpha
    plane or None; and its frame header.  ``filter_level_override``
    replaces the frame's loop-filter level."""
    st, coeffs, modes = decode_vp8_symbols(
        payload, bypass_filtering=config.bypass_filtering,
        filter_level_override=filter_level_override)
    plane = (None if alpha_payload is None
             else decode_alpha(alpha_payload, st.width, st.height))
    dc, dm, dfp, alpha = _upload(
        [(0, st, coeffs, modes, vp8_filter_params(st, modes), plane)], dev)
    Y, U, V = recon_frame(
        dc, dm[:, :, 0], dm[:, :, 5:21], dm[:, :, 1],
        dfp.reshape(1, st.mb_h, st.mb_w, 4), mb_w=st.mb_w, mb_h=st.mb_h,
        filter_type=st.filter_type)
    deltas = dither_deltas(st, modes, config.dithering_strength)
    if deltas is not None:
        d = torch.from_numpy(np.stack(deltas)).to(dev)
        U, V = ((p.to(torch.int16) + dp).clamp(0, 255).to(torch.uint8)
                for p, dp in ((U, d[0]), (V, d[1])))
    return Y, U, V, alpha, st


def _lossy_chunk(parsed):
    vp8 = parsed.find(CHUNK_VP8)
    if vp8 is None:
        raise BitstreamError("YUV output requires a lossy (VP8) file")
    return vp8.payload


def decode(data: bytes, config: DecoderConfig | None = None,
           mode: str = "RGBA", *, device=None) -> np.ndarray:
    """Decode a .webp file with options → (H, W, C) uint8 array.

    ``mode`` takes libwebp's colorspaces: RGBA/BGRA/ARGB/RGB/BGR,
    premultiplied rgbA/bgrA/Argb/rgbA_4444, and the packed
    RGB_565/RGBA_4444 (returned as (H, W, 2) byte pairs).  ``device`` None
    means CUDA and raises when CUDA is absent, before any work;
    ``device="cpu"`` runs the kernels' plain versions (identical pixels).
    A lossless file decodes on the host whatever ``device`` says.
    """
    dev = resolve_device(device)
    premult = mode in _MODE_PREMULT
    if premult:
        mode = _MODE_PREMULT[mode]
    if mode not in _MODE_PERMUTE and mode not in _MODE_PACKED:
        known = (sorted(_MODE_PERMUTE) + list(_MODE_PACKED)
                 + sorted(_MODE_PREMULT))
        raise ValueError(f"bad mode {mode!r} (use {known})")
    config = config or DecoderConfig()
    parsed = parse_riff(data)
    vp8l = parsed.find(CHUNK_VP8L)
    if vp8l is not None:
        rgba = torch.from_numpy(decode_vp8l(vp8l.payload))
    else:
        vp8 = parsed.find(CHUNK_VP8)
        if vp8 is None:
            raise BitstreamError("no decodable image chunk found")
        alpha_chunk = parsed.find(CHUNK_ALPHA)
        Y, U, V, alpha, st = _vp8_planes(
            vp8.payload, alpha_chunk.payload if alpha_chunk else None, config,
            dev)
        rgba = yuv420_to_rgba(Y, U, V, st.height, st.width, alpha,
                              fancy=not config.no_fancy_upsampling)[0]
    rgba = _alpha_dither(rgba, config.alpha_dithering_strength)
    rgba = apply_output_options(rgba, config)
    if premult:
        rgba = _premultiply(rgba)
    if mode in _MODE_PACKED:
        rgba = _pack_16bit(rgba, mode)
    elif _MODE_PERMUTE[mode] != tuple(range(rgba.shape[2])):
        rgba = rgba[..., list(_MODE_PERMUTE[mode])]
    return rgba.contiguous().cpu().numpy()


def decode_rgba(data: bytes, config: DecoderConfig | None = None, *,
                device=None) -> np.ndarray:
    """Decode a .webp file (still image) to an (H, W, 4) uint8 RGBA array."""
    return decode(data, config, "RGBA", device=device)


def decode_rgb(data: bytes, config: DecoderConfig | None = None, *,
               device=None) -> np.ndarray:
    """Decode a .webp file (still image) to an (H, W, 3) uint8 RGB array."""
    return decode(data, config, "RGB", device=device)


def decode_into(data: bytes, out: np.ndarray,
                config: DecoderConfig | None = None,
                mode: str | None = None, *, device=None) -> np.ndarray:
    """Decode into a caller-owned (possibly strided) (H, W, C) uint8
    array, such as a window of a larger batch buffer.

    H and W must match the decoded output under ``config`` (after any crop
    or scale) and C the ``mode`` (default: RGBA for C=4, RGB for C=3);
    else ValueError.  Returns ``out``.
    """
    out = np.asanyarray(out)
    if out.dtype != np.uint8 or out.ndim != 3:
        raise ValueError("out must be an (H, W, C) uint8 array")
    if mode is None:
        if out.shape[2] == 4:
            mode = "RGBA"
        elif out.shape[2] == 3:
            mode = "RGB"
        else:
            raise ValueError("packed modes need an explicit mode=")
    want_c = _MODE_CHANNELS.get(mode)
    if want_c is None:
        raise ValueError(f"bad mode {mode!r}")
    if out.shape[2] != want_c:
        raise ValueError(
            f"out has {out.shape[2]} channels, mode {mode} needs {want_c}")
    result = decode(data, config, mode, device=device)
    if result.shape != out.shape:
        raise ValueError(
            f"out shape {out.shape} != decoded shape {result.shape}")
    np.copyto(out, result)
    return out


def decode_yuv(data: bytes, *, device=None):
    """Decode a lossy file to its (y, u, v) uint8 planes, cropped to the
    frame (chroma ⌈H/2⌉ x ⌈W/2⌉)."""
    dev = resolve_device(device)
    return decode_vp8_yuv(_lossy_chunk(parse_riff(data)), device=dev)


def decode_vp8_yuv(payload: bytes, *, filter_level_override=None, device):
    """A VP8 chunk payload → its (y, u, v) uint8 numpy planes, cropped:
    the encoder's own decode (filter-level trials, rate control, PSNR),
    through the recon and loop-filter kernel on ``device``."""
    Y, U, V, _, st = _vp8_planes(payload, None, DecoderConfig(), device,
                                 filter_level_override)
    H, W = st.height, st.width
    h2, w2 = (H + 1) // 2, (W + 1) // 2
    return tuple(p.contiguous().cpu().numpy()
                 for p in (Y[0, :H, :W], U[0, :h2, :w2], V[0, :h2, :w2]))


def decode_yuva(data: bytes, config: DecoderConfig | None = None, *,
                device=None):
    """Decode a lossy file to (y, u, v, a) uint8 planes with the output
    options: crop (offsets snap down to even for chroma alignment), then a
    rescale of each plane, then flip.  ``a`` is None for a file without an
    ALPH chunk.
    """
    dev = resolve_device(device)
    config = config or DecoderConfig()
    parsed = parse_riff(data)
    payload = _lossy_chunk(parsed)
    alpha_chunk = parsed.find(CHUNK_ALPHA)
    Y, U, V, alpha, st = _vp8_planes(
        payload, alpha_chunk.payload if alpha_chunk else None, config, dev)
    H, W = st.height, st.width
    h2, w2 = (H + 1) // 2, (W + 1) // 2
    y, u, v = Y[0, :H, :W], U[0, :h2, :w2], V[0, :h2, :w2]
    a = None if alpha is None else alpha[0]
    config.validate(W, H)
    if config.use_cropping:
        left, top = config.crop_left & ~1, config.crop_top & ~1
        cw, ch = config.crop_width, config.crop_height
        y = y[top:top + ch, left:left + cw]
        u = u[top // 2:(top + ch + 1) // 2, left // 2:(left + cw + 1) // 2]
        v = v[top // 2:(top + ch + 1) // 2, left // 2:(left + cw + 1) // 2]
        if a is not None:
            a = a[top:top + ch, left:left + cw]
    if config.use_scaling:
        sw, sh = config.resolve_scale(y.shape[1], y.shape[0])

        def rs(p, w_, h_):
            return _rescale(p[..., None], w_, h_)[..., 0]

        y, u, v = (rs(y, sw, sh), rs(u, (sw + 1) // 2, (sh + 1) // 2),
                   rs(v, (sw + 1) // 2, (sh + 1) // 2))
        if a is not None:
            a = rs(a, sw, sh)
    if config.flip:
        y, u, v = y.flip(0), u.flip(0), v.flip(0)
        if a is not None:
            a = a.flip(0)
    planes = [p.contiguous().cpu().numpy() for p in (y, u, v)]
    return (*planes, None if a is None else a.contiguous().cpu().numpy())


def features(data: bytes) -> WebPFeatures:
    """Probe a file's size, alpha, animation and format from its headers
    (no pixel work, so no device)."""
    return get_features(data)


__all__ = ["DecoderConfig", "decode", "decode_into", "decode_rgb",
           "decode_rgba", "decode_rgba_batch", "decode_yuv", "decode_yuva",
           "features"]
