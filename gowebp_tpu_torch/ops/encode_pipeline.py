"""Pipelined batch lossy encode: host uint8 RGB → .webp bytes.

Per chunk of same-shaped images:

  1. host (thread pool, ahead of the device): native RGB→YUV420, edge
     pad to macroblock multiples, segmentation and the per-image
     quantizer/penalty rows;
  2. one h2d upload of the chunk's packed uint8 planes;
  3. device: the dense encode and a group-of-4 nibble/byte pack of the
     level tensors (G4PACKv2).  engine="hybrid" runs
     ops/encode_wavefront.py (cold search, wavefront, refine search with
     the i4 kernel, wavefront); engine="openloop" runs
     ops/encode_plane.py (the luma and chroma plane kernels, no
     segmentation, one quantizer set, i16 modes only);
  4. one d2h download of a single fused uint8 buffer;
  5. host (thread pool, overlapping the next chunk's device work):
     unpack to dense int16 levels and two-pass token emission through
     the native C++ tokenizer.

G4PACKv2 wire format (per image):
  flat  = concat(y2_levels, y_levels, uv_levels), zigzag int16,
          zero-padded to a multiple of 32 coefficients
  group g = flat[4g : 4g+4], state 0 = all zero, 1 = "small" (all four
          in [-8, 7], two nibble bytes), 2 = "big" (four int8 bytes);
          states packed 4 per byte, LSB first
  escape: any |level| > 127, or more groups than a stream's capacity,
          sends that image's dense int16 levels instead — correctness
          never depends on the compact path.

Output bytes are identical on every device: the device only routes the
dense stage to the CUDA kernels or to their plain torch versions.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import torch

from ..config import EncoderConfig
from ..constants import CHUNK_VP8
from ..container.riff import Chunk, assemble_simple
from ..device import StageClock, resolve_device
from ..errors import EncodeError, UnsupportedFeature
from ..models.vp8.encoder import (ERROR_DIFFUSION_QUALITY, _default_cost_tables,
                                  _i4_config_seg, _segment_tree_probs,
                                  analyze_segments, emit_frame_arrays,
                                  make_quants, quality_to_q, rgb_to_yuv420)
from ..params import params_from_numpy
from .encode_plane import encode_plane_core_v2
from .encode_wavefront import encode_hybrid_core

GROUP = 4  # coefficients per group state
ENGINES = ("hybrid", "openloop")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` names a ported dense encoder."""
    if engine == "wavefront":
        raise UnsupportedFeature(
            'engine="wavefront" (the exact full-search wavefront) is not '
            "ported yet (ROADMAP.md Queue 1 item 2)")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def _plan(h: int, w: int):
    """Static per-shape layout: padded dims, coeff counts, group counts."""
    H = (h + 15) // 16 * 16
    W = (w + 15) // 16 * 16
    mb_h, mb_w = H // 16, W // 16
    total = mb_h * mb_w
    n_coeff = total * (16 + 256 + 128)
    n_group = (n_coeff + GROUP - 1) // GROUP
    n_group_pad = (n_group + 7) // 8 * 8
    return {
        "H": H, "W": W, "mb_h": mb_h, "mb_w": mb_w, "total": total,
        "n_coeff": n_coeff, "n_group": n_group, "n_group_pad": n_group_pad,
    }


def _levels_to_flat(out, plan):
    """Level tensors → (B, n_group_pad * 4) int32 in wire order."""
    B = out["y_levels"].shape[0]
    flat = torch.cat([out[k].reshape(B, -1).to(torch.int32)
                      for k in ("y2_levels", "y_levels", "uv_levels")], dim=1)
    pad = plan["n_group_pad"] * GROUP - plan["n_coeff"]
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat


def _compact(g, pred, cap: int, pad_val: int):
    """The first ``cap`` groups where ``pred`` holds, in ascending order,
    padded with ``pad_val`` → (B, cap, 4)."""
    B, ng = pred.shape
    pos = torch.cumsum(pred, dim=1, dtype=torch.int64) - 1
    keep = pred & (pos < cap)
    rows = torch.arange(B, device=g.device)[:, None] * cap
    dummy = B * cap                         # sink row for groups not kept
    idx = torch.where(keep, rows + pos, dummy).reshape(-1)
    out = torch.full((B * cap + 1, GROUP), pad_val, dtype=g.dtype,
                     device=g.device)
    src = torch.where(keep[..., None], g, pad_val).reshape(-1, GROUP)
    out.index_copy_(0, idx, src)
    return out[:dummy].reshape(B, cap, GROUP)


def _pack_g4v2(flat, cap_s: int, cap_b: int):
    """(B, n_coeff_pad) int32 → nibble/byte dual-stream pack (G4PACKv2).

    Returns (mask2 (B, ng/4) uint8, small (B, cap_s, 2) uint8,
    big (B, cap_b, 4) int8, counts_s, counts_b, maxabs (B,) int32).
    """
    B = flat.shape[0]
    g = flat.reshape(B, -1, GROUP)
    nz = (g != 0).any(-1)
    small = nz & (g.amax(-1) <= 7) & (g.amin(-1) >= -8)
    big = nz & ~small
    state = small.to(torch.int32) + 2 * big.to(torch.int32)
    counts_s = small.sum(1, dtype=torch.int32)
    counts_b = big.sum(1, dtype=torch.int32)
    maxabs = flat.abs().amax(1).to(torch.int32)
    w4 = torch.tensor([1, 4, 16, 64], dtype=torch.int32, device=flat.device)
    mask2 = (state.reshape(B, -1, 4) * w4).sum(-1).to(torch.uint8)
    n = (_compact(g, small, cap_s, -8) + 8) & 0xF
    small_b = torch.stack([n[..., 0] | (n[..., 1] << 4),
                           n[..., 2] | (n[..., 3] << 4)], -1).to(torch.uint8)
    big_b = _compact(g, big, cap_b, 0).clamp(-128, 127).to(torch.int8)
    return mask2, small_b, big_b, counts_s, counts_b, maxabs


def unpack_g4v2(mask2: np.ndarray, small: np.ndarray, big: np.ndarray,
                cs: int, cb: int, plan: dict):
    """G4PACKv2 arrays (one image) → (y2, yl, uvl) int16 views."""
    ng = plan["n_group_pad"]
    states = (
        (mask2[:, None] >> (2 * np.arange(4, dtype=np.uint8))) & 3
    ).reshape(-1)[:ng]
    flat = np.zeros((ng, GROUP), np.int16)
    s_idx = np.nonzero(states == 1)[0]
    sm = small[:cs]
    flat[s_idx] = (
        np.stack([sm[:, 0] & 0xF, sm[:, 0] >> 4,
                  sm[:, 1] & 0xF, sm[:, 1] >> 4], axis=-1).astype(np.int16)
        - 8
    )
    b_idx = np.nonzero(states == 2)[0]
    flat[b_idx] = big[:cb].astype(np.int16)
    flat = flat.reshape(-1)[: plan["n_coeff"]]
    t = plan["total"]
    y2 = flat[: t * 16].reshape(t, 16)
    yl = flat[t * 16 : t * 272].reshape(t, 16, 16)
    uvl = flat[t * 272 :].reshape(t, 8, 16)
    return y2, yl, uvl


def planes_wavefront_packed_step(y, u, v, seg_map, qsteps, tables, *,
                                 cap_s, cap_b, i4_penalty,
                                 use_derr: bool = False, marks=None):
    """uint8 MB-padded YUV420 planes → hybrid encode + G4PACKv2.

    Everything stays on the planes' device; the modes and the dense
    levels ride along for emission and the escape path.
    """
    out = encode_hybrid_core(y, u, v, seg_map, qsteps, tables,
                             i4_penalty=i4_penalty, use_derr=use_derr,
                             marks=marks)
    return _with_pack(out, y.shape, cap_s, cap_b, marks)


def planes_packed_step(y, u, v, *, y1_dc, y1_ac, y2_dc, y2_ac, uv_dc,
                       uv_ac, cap_s, cap_b, marks=None):
    """uint8 MB-padded YUV420 planes → open-loop encode + G4PACKv2.

    One quantizer set for every MB (no segments); the result carries no
    is_i4/imodes (every MB is i16).
    """
    out = encode_plane_core_v2(y, u, v, y1_dc=y1_dc, y1_ac=y1_ac,
                               y2_dc=y2_dc, y2_ac=y2_ac, uv_dc=uv_dc,
                               uv_ac=uv_ac, marks=marks)
    return _with_pack(out, y.shape, cap_s, cap_b, marks)


def _with_pack(out, shape, cap_s: int, cap_b: int, marks):
    """The dense engine's outputs plus their G4PACKv2 pack."""
    mask2, small, big, cs, cb, maxabs = _pack_g4v2(
        _levels_to_flat(out, _plan(shape[1], shape[2])), cap_s, cap_b)
    if marks is not None:
        marks("pack")
    return dict(out, mask2=mask2, small=small, big=big,
                hdr=torch.stack([cs, cb, maxabs], dim=1))


def _export_packed_v2(out, *, ks: int, kb: int):
    """One fused uint8 device buffer per chunk (one d2h).

    Per image: [hdr (counts_s, counts_b, maxabs) int32 as 12 bytes |
    mask2 | small[:ks] | big[:kb] | ymode | uvmode], then, for the
    hybrid engine only, [is_i4 | imodes].
    """
    B = out["mask2"].shape[0]
    u8 = torch.uint8
    parts = [
        out["hdr"].contiguous().view(u8).reshape(B, -1),
        out["mask2"],
        out["small"][:, :ks].reshape(B, -1),
        out["big"][:, :kb].contiguous().view(u8).reshape(B, -1),
        out["ymode"].reshape(B, -1).to(u8),
        out["uvmode"].reshape(B, -1).to(u8),
    ]
    if "is_i4" in out:
        parts += [out["is_i4"].reshape(B, -1).to(u8),
                  out["imodes"].reshape(B, -1).to(u8)]
    return torch.cat(parts, dim=1)


def _bucket(kmax: int, cap: int) -> int:
    """Round a chunk's max group count up to a power of two (≥4096).

    Export buckets only grow, so a run downloads a few stable sizes
    instead of one per chunk.
    """
    b = 4096
    while b < kmax:
        b *= 2
    return min(b, cap)


def _qrow(sq):
    """A quantizer set's steps: y1 dc/ac, y2 dc/ac, uv dc/ac."""
    return (sq.y1_dc.q, sq.y1_ac.q, sq.y2_dc.q, sq.y2_ac.q, sq.uv_dc.q,
            sq.uv_ac.q)


def encode_setup(quality: float, h: int, w: int) -> dict:
    """A batch's settings: the default lossy config at ``quality``, its
    base quantizer (clamped to qmin/qmax) and quantizer row, whether UV
    DC error diffusion is on, and the MB layout of h x w images."""
    config = EncoderConfig(lossless=False, quality=quality)
    config.validate()
    base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100,
                 min(config.qmax * 127 // 100, base_q))
    return {"config": config, "base_q": base_q,
            "base_row": np.array(_qrow(make_quants(base_q)), np.int32),
            "use_derr": config.quality <= ERROR_DIFFUSION_QUALITY,
            "h": h, "w": w, "plan": _plan(h + (h & 1), w + (w & 1))}


def prep_image(im, setup: dict, *, openloop: bool):
    """Host: one image's MB-padded planes in one wire buffer, and its
    segmentation (the hybrid engine only).

    Returns (flat uint8 y|u|v, seg dict or None, quantizer rows (4, 6),
    per-segment i4 penalties (4,)).
    """
    config, base_q, plan = setup["config"], setup["base_q"], setup["plan"]
    h, w = setup["h"], setup["w"]
    H, W, mh, mw = plan["H"], plan["W"], plan["mb_h"], plan["mb_w"]
    im = np.asarray(im)
    if im.shape[:2] != (h, w):
        raise EncodeError("all images of a batch must share one shape")
    rgb = im[..., :3]
    if (h & 1) or (w & 1):
        rgb = np.pad(rgb, ((0, h & 1), (0, w & 1), (0, 0)), mode="edge")
    yp, up, vp = rgb_to_yuv420(rgb)
    yp = np.pad(yp.astype(np.uint8),
                ((0, H - yp.shape[0]), (0, W - yp.shape[1])), mode="edge")
    up = np.pad(up.astype(np.uint8),
                ((0, H // 2 - up.shape[0]), (0, W // 2 - up.shape[1])),
                mode="edge")
    vp = np.pad(vp.astype(np.uint8),
                ((0, H // 2 - vp.shape[0]), (0, W // 2 - vp.shape[1])),
                mode="edge")
    flat = np.concatenate([yp.reshape(-1), up.reshape(-1), vp.reshape(-1)])
    rows = np.broadcast_to(setup["base_row"], (4, 6))
    seg = None
    if not openloop and config.segments > 1:
        seg_map, deltas = analyze_segments(
            yp, mw, mh, config.segments, config.sns_strength, base_q)
        if len(set(deltas[: config.segments])) > 1:
            seg = {
                "map": seg_map,
                "deltas": deltas,
                "probs": _segment_tree_probs(seg_map),
                "quants": [make_quants(max(0, min(127, base_q + d)))
                           for d in deltas],
            }
            rows = np.array([_qrow(s) for s in seg["quants"]], np.int32)
    pens = (np.zeros(4, np.int32) if openloop else
            _i4_config_seg(rows, config.method, config.partition_limit)[1])
    return flat, seg, rows, pens


def stack_prepped(prepped):
    """``prep_image`` results of a chunk → (flat (B, n) uint8, segs,
    rows (B, 4, 6), pens (B, 4))."""
    return (np.stack([p[0] for p in prepped]), [p[1] for p in prepped],
            np.stack([p[2] for p in prepped]),
            np.stack([p[3] for p in prepped]))


def upload_planes(flat, plan, dev):
    """A chunk's wire buffer → y, u, v planes on ``dev``: one h2d, then
    views."""
    B = flat.shape[0]
    H, W = plan["H"], plan["W"]
    ys_len, cs_len = H * W, (H // 2) * (W // 2)
    buf = torch.from_numpy(flat).to(dev)
    return (buf[:, :ys_len].reshape(B, H, W),
            buf[:, ys_len:ys_len + cs_len].reshape(B, H // 2, W // 2),
            buf[:, ys_len + cs_len:].reshape(B, H // 2, W // 2))


def hybrid_params(segs, rows, pens, plan, tables_np, dev):
    """A chunk's segmentations, quantizer rows and penalties, and the
    cost tables → the hybrid core's (tables, qsteps, seg_map, i4_penalty)
    on ``dev``; an image with one segment gets an all-zero map."""
    mh, mw = plan["mb_h"], plan["mb_w"]
    seg_maps = np.stack([
        (s["map"].reshape(mh, mw) if s is not None
         else np.zeros((mh, mw), np.int32)) for s in segs])
    return params_from_numpy(tables_np, rows, seg_maps, pens, device=dev)


def encode_rgba_batch_pipelined(images, *, quality: float = 75.0,
                                threads: int = 2, chunk: int = 8,
                                device=None, engine: str = "hybrid",
                                timings: dict | None = None):
    """Lossy-encode same-shaped uint8 RGB(A) images.

    Default encoder settings (method 4, 4 segments) at ``quality``.
    ``engine`` "hybrid" runs the exact closed-loop hybrid encode;
    "openloop" the open-loop plane engine (fastest, lower quality: no
    segmentation, i16 modes only, prediction drift).

    Returns a list of complete .webp byte strings (order preserved).
    ``device`` None means CUDA (raises without it); "cpu" runs the
    kernels' plain versions with identical output.  ``timings``, if
    given, accumulates per-stage milliseconds under "stage_ms" (device
    stages from CUDA events on a GPU), host emit seconds under
    "emit_thread_s" and the wall clock under "total".
    """
    check_engine(engine)
    if not images:
        return []
    dev = resolve_device(device)
    openloop = engine == "openloop"
    t_total = time.perf_counter()
    first = np.asarray(images[0])
    h, w = first.shape[:2]
    setup = encode_setup(quality, h, w)
    config, base_q, plan = setup["config"], setup["base_q"], setup["plan"]
    tables_np = _default_cost_tables()
    quants = dict(zip(("y1_dc", "y1_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac"),
                      (int(x) for x in setup["base_row"])))
    n = len(images)
    mh, mw = plan["mb_h"], plan["mb_w"]
    cap_s = plan["n_group_pad"] // 2
    cap_b = plan["n_group_pad"] // 4
    if timings is not None:
        timings.setdefault("stage_ms", {})
        for k in ("emit_thread_s", "total"):
            timings.setdefault(k, 0.0)

    def prep_one(im):
        return prep_image(im, setup, openloop=openloop)

    def emit_one(j, fetched, seg, dense):
        t0 = time.perf_counter()
        try:
            if dense is None:
                y2, yl, uvl = unpack_g4v2(
                    fetched["mask2"][j], fetched["small"][j],
                    fetched["big"][j], int(fetched["cs"][j]),
                    int(fetched["cb"][j]), plan)
            else:
                y2, yl, uvl = dense
            payload = emit_frame_arrays(
                y2, yl, uvl, fetched["is_i4"][j], fetched["ymode"][j],
                fetched["uvmode"][j], mw, mh, w, h, base_q, config,
                imodes=fetched["imodes"][j], seg=seg)
            return assemble_simple(Chunk(CHUNK_VP8, payload))
        finally:
            if timings is not None:
                timings["emit_thread_s"] += time.perf_counter() - t0

    def dispatch(prepped, clock):
        flat, segs, qs, pens = prepped
        yd, ud, vd = upload_planes(flat, plan, dev)          # ONE h2d
        if clock is not None:
            clock("h2d")
        if openloop:
            return planes_packed_step(yd, ud, vd, cap_s=cap_s, cap_b=cap_b,
                                      marks=clock, **quants)
        tables, qs_t, seg_t, pens_t = hybrid_params(segs, qs, pens, plan,
                                                    tables_np, dev)
        return planes_wavefront_packed_step(
            yd, ud, vd, seg_t, qs_t, tables, cap_s=cap_s, cap_b=cap_b,
            i4_penalty=pens_t, use_derr=setup["use_derr"], marks=clock)

    sticky = {"ks": min(4096, cap_s), "kb": min(4096, cap_b)}
    t = plan["total"]
    n_mask = plan["n_group_pad"] // 4

    def fetch(out, clock):
        """Blocking d2h at the sticky buckets; one re-export when a chunk
        overflows them."""
        def once(ks, kb):
            buf = _export_packed_v2(out, ks=ks, kb=kb).cpu().numpy()
            hdr = buf[:, :12].copy().view(np.int32).reshape(-1, 3)
            return buf, hdr
        ks, kb = sticky["ks"], sticky["kb"]
        buf, hdr = once(ks, kb)
        need_ks = _bucket(max(1, int(hdr[:, 0].max())), cap_s)
        need_kb = _bucket(max(1, int(hdr[:, 1].max())), cap_b)
        if need_ks > ks or need_kb > kb:
            ks, kb = max(ks, need_ks), max(kb, need_kb)
            sticky["ks"], sticky["kb"] = ks, kb
            buf, hdr = once(ks, kb)
        if clock is not None:
            clock("d2h")
        nb = buf.shape[0]
        o = 12
        got = {"cs": hdr[:, 0], "cb": hdr[:, 1], "maxabs": hdr[:, 2]}
        got["mask2"] = buf[:, o:o + n_mask]; o += n_mask
        got["small"] = buf[:, o:o + ks * 2].reshape(nb, ks, 2); o += ks * 2
        got["big"] = buf[:, o:o + kb * GROUP].view(np.int8).reshape(
            nb, kb, GROUP); o += kb * GROUP
        got["ymode"] = buf[:, o:o + t]; o += t
        got["uvmode"] = buf[:, o:o + t]; o += t
        if "is_i4" in out:
            got["is_i4"] = buf[:, o:o + t]; o += t
            got["imodes"] = buf[:, o:o + t * 16].reshape(nb, t, 16)
        else:                      # open-loop: every MB i16
            got["is_i4"] = np.zeros((nb, t), np.uint8)
            got["imodes"] = (None,) * nb
        return got

    results = [None] * n
    chunk = max(1, chunk)
    starts = list(range(0, n, chunk))

    def prep_chunk(s, pool):
        return stack_prepped(list(pool.map(prep_one, images[s:s + chunk])))

    workers = max(1, threads)
    with cf.ThreadPoolExecutor(max_workers=workers) as pool, \
            cf.ThreadPoolExecutor(max_workers=1) as ahead:
        emit_futs = []
        nxt = ahead.submit(prep_chunk, starts[0], pool)
        for i, s in enumerate(starts):
            prepped = nxt.result()
            if i + 1 < len(starts):        # host prep of the next chunk
                nxt = ahead.submit(prep_chunk, starts[i + 1], pool)
            clock = StageClock(dev) if timings is not None else None
            out = dispatch(prepped, clock)
            got = fetch(out, clock)
            if clock is not None:
                for k, ms in clock.spans_ms().items():
                    timings["stage_ms"][k] = timings["stage_ms"].get(k, 0.0) + ms
            segs = prepped[1]
            for j in range(len(segs)):
                dense = None
                if (got["maxabs"][j] > 127 or got["cs"][j] > cap_s
                        or got["cb"][j] > cap_b):
                    dense = (out["y2_levels"][j].cpu().numpy().reshape(t, 16),
                             out["y_levels"][j].cpu().numpy().reshape(t, 16, 16),
                             out["uv_levels"][j].cpu().numpy().reshape(t, 8, 16))
                emit_futs.append((s + j, pool.submit(
                    emit_one, j, got, segs[j], dense)))
        for gi, fut in emit_futs:
            results[gi] = fut.result()
    if timings is not None:
        timings["total"] += time.perf_counter() - t_total
    return results


__all__ = [
    "check_engine",
    "encode_rgba_batch_pipelined",
    "encode_setup",
    "hybrid_params",
    "planes_packed_step",
    "planes_wavefront_packed_step",
    "prep_image",
    "stack_prepped",
    "unpack_g4v2",
    "upload_planes",
]
