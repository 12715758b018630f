"""Pipelined batch lossy encode: host uint8 RGB → .webp bytes.

Per chunk of same-shaped images, with ``depth`` chunks in flight:

  1. host (thread pools, up to ``depth`` chunks ahead of the device):
     native RGB→YUV420, edge pad to macroblock multiples, segmentation
     and the per-image quantizer/penalty rows, written straight into one
     of ``depth + 1`` pinned staging buffers;
  2. main thread: one asynchronous h2d of the chunk's packed uint8
     planes from that buffer (a CUDA event guards the buffer's reuse);
  3. main thread, device: the dense encode, a group-of-4 nibble/byte
     pack of the level tensors (G4PACKv2) and the export of a single
     fused uint8 buffer.  engine="hybrid" runs ops/encode_wavefront.py
     (cold search, then wavefront passes and refine searches with the i4
     kernels); engine="wavefront" runs the exact engine there (the mode
     search inside the closed loop, one launch of the full-search
     kernel); engine="openloop" runs ops/encode_plane.py (the luma and
     chroma plane kernels, no segmentation, one quantizer set, i16 modes
     only);
  4. fetch thread: the d2h of that buffer into pinned memory on a side
     stream that waits only for this chunk's export, so it overlaps the
     next chunks' device work; the main thread blocks only when
     ``depth`` fetches are pending;
  5. host (thread pool): unpack to dense int16 levels and two-pass token
     emission through the native C++ tokenizer.

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
import contextlib
from collections import deque

import numpy as np
import torch

from ..config import EncoderConfig
from ..constants import CHUNK_VP8
from ..container.riff import Chunk, assemble_simple
from .. import tracing
from ..device import resolve_device
from ..errors import EncodeError
from ..models.vp8.encoder import (ERROR_DIFFUSION_QUALITY, _default_cost_tables,
                                  _i4_config_seg, _segment_tree_probs,
                                  analyze_segments, emit_frame_arrays,
                                  make_quants, quality_to_q, rgb_to_yuv420)
from ..params import params_from_numpy
from .encode_plane import encode_plane_core_v2
from .encode_wavefront import encode_hybrid_core, encode_wavefront_core
from .kernels.i4_search import check_topk

GROUP = 4  # coefficients per group state
ENGINES = ("hybrid", "wavefront", "openloop")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` names a dense encoder: "hybrid",
    "wavefront" (the exact full search) or "openloop"."""
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
    shifts = 2 * torch.arange(4, dtype=torch.int32, device=flat.device)
    mask2 = (state.reshape(B, -1, 4) << shifts).sum(-1).to(torch.uint8)
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
                                 cap_s, cap_b, i4_penalty, try_i4: bool = True,
                                 use_derr: bool = False, refine: int = 1,
                                 cold: str = "i16", i4_topk=None,
                                 search: str = "open", marks=None):
    """uint8 MB-padded YUV420 planes → closed-loop encode + G4PACKv2.

    ``search`` "open": the hybrid engine (``encode_hybrid_core``, which
    takes ``refine``, ``cold`` and ``i4_topk``); "closed": the exact
    engine (``encode_wavefront_core`` with the mode search in the loop,
    one stage "wavefront"; ``refine``, ``cold`` and ``i4_topk`` change
    nothing).  Everything stays on the planes' device; the modes and the
    dense levels ride along for emission and the escape path.
    """
    if search == "closed":
        out = encode_wavefront_core(y, u, v, seg_map, qsteps, tables,
                                    try_i4=try_i4, i4_penalty=i4_penalty,
                                    use_derr=use_derr)
        if marks is not None:
            marks("wavefront")
    elif search == "open":
        out = encode_hybrid_core(y, u, v, seg_map, qsteps, tables,
                                 i4_penalty=i4_penalty, try_i4=try_i4,
                                 refine=refine, cold=cold, i4_topk=i4_topk,
                                 use_derr=use_derr, marks=marks)
    else:
        raise ValueError(f"unknown search {search!r}; expected \"open\" "
                         f"or \"closed\"")
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
    engines that code i4 MBs (hybrid and wavefront), [is_i4 | imodes].
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


FIRST_BUCKET = 4096   # groups per stream in a run's first export


def _bucket(kmax: int, cap: int) -> int:
    """Round a chunk's max group count up to a power of two (at least
    FIRST_BUCKET).

    Export buckets only grow, so a run downloads a few stable sizes
    instead of one per chunk.
    """
    b = FIRST_BUCKET
    while b < kmax:
        b *= 2
    return min(b, cap)


def _qrow(sq):
    """A quantizer set's steps: y1 dc/ac, y2 dc/ac, uv dc/ac."""
    return (sq.y1_dc.q, sq.y1_ac.q, sq.y2_dc.q, sq.y2_ac.q, sq.uv_dc.q,
            sq.uv_ac.q)


def encode_setup(quality: float, h: int, w: int, config=None) -> dict:
    """A batch's settings: ``config`` (default: the default lossy config
    at ``quality``; a given config's own quality rules), its base
    quantizer (clamped to qmin/qmax) and quantizer row, whether UV DC
    error diffusion is on, whether the i4 search runs (method >= 4 and
    partition_limit < 100), and the MB layout of h x w images."""
    if config is None:
        config = EncoderConfig(lossless=False, quality=quality)
    config.validate()
    base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100,
                 min(config.qmax * 127 // 100, base_q))
    try_i4, _ = _i4_config_seg(np.zeros((4, 6), np.int32), config.method,
                               config.partition_limit)
    return {"config": config, "base_q": base_q,
            "base_row": np.array(_qrow(make_quants(base_q)), np.int32),
            "use_derr": config.quality <= ERROR_DIFFUSION_QUALITY,
            "try_i4": try_i4,
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


def split_planes(buf, plan):
    """A chunk's (B, 1.5 * H * W) uint8 wire buffer → y, u, v views."""
    B = buf.shape[0]
    H, W = plan["H"], plan["W"]
    ys_len, cs_len = H * W, (H // 2) * (W // 2)
    return (buf[:, :ys_len].reshape(B, H, W),
            buf[:, ys_len:ys_len + cs_len].reshape(B, H // 2, W // 2),
            buf[:, ys_len + cs_len:].reshape(B, H // 2, W // 2))


class StagingRing:
    """``n`` host buffers of (rows, cols) uint8 that take turns holding a
    chunk's wire buffer for its h2d.

    On CUDA they are pinned, the upload is asynchronous, and the event
    recorded after it guards the buffer: ``slot`` waits for it before
    the buffer is written again.  On the CPU the "upload" is a copy.
    """

    def __init__(self, n: int, rows: int, cols: int, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.bufs = [torch.empty((rows, cols), dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in range(n)]
        self.events = [None] * n

    def slot(self, i: int) -> np.ndarray:
        """Buffer of chunk ``i`` as NumPy, once its last upload is done."""
        k = i % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
        return self.bufs[k].numpy()

    def upload(self, i: int, rows: int) -> torch.Tensor:
        """The first ``rows`` rows of chunk ``i``'s buffer on the device."""
        k = i % len(self.bufs)
        host = self.bufs[k][:rows]
        if not self.cuda:
            return host.clone()
        buf = host.to(self.dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events[k] = ev
        return buf


def hybrid_params(segs, rows, pens, plan, tables_np, dev):
    """A chunk's segmentations, quantizer rows and penalties, and the
    cost tables → the hybrid core's (tables, qsteps, seg_map, i4_penalty)
    on ``dev``; an image with one segment gets an all-zero map."""
    mh, mw = plan["mb_h"], plan["mb_w"]
    seg_maps = np.stack([
        (s["map"].reshape(mh, mw) if s is not None
         else np.zeros((mh, mw), np.int32)) for s in segs])
    return params_from_numpy(tables_np, rows, seg_maps, pens, device=dev)


COLD_ROUNDS = ("i16", "dense")


def check_hybrid_options(refine: int, cold: str, i4_topk) -> None:
    """Raise unless ``refine`` >= 0, ``cold`` names a cold-round search
    and ``i4_topk`` is None or 1..10."""
    if isinstance(refine, bool) or not isinstance(refine, int) or refine < 0:
        raise ValueError(f"refine must be an int >= 0, got {refine!r}")
    if cold not in COLD_ROUNDS:
        raise ValueError(f"unknown cold {cold!r}; expected one of "
                         f"{COLD_ROUNDS}")
    check_topk(i4_topk)


# span → ``timings`` key of its summed seconds
_SUMS = {"encode.prep": "prep", "encode.h2d": "h2d", "encode.fetch": "fetch",
         "encode.emit": "emit_thread_s", "encode.call": "total"}


def encode_rgba_batch_pipelined(images, *, quality: float = 75.0,
                                threads: int = 2, chunk: int = 8,
                                device=None, engine: str = "hybrid",
                                config=None, depth: int = 3,
                                timings: dict | None = None,
                                refine: int = 1, cold: str = "i16",
                                i4_topk=None):
    """Lossy-encode same-shaped uint8 RGB(A) images.

    ``config`` (an ``EncoderConfig``; default: method 4, 4 segments at
    ``quality``) sets the quantizer, segmentation, the i4 search and the
    frame header's filter and partition fields.  ``engine`` "hybrid"
    runs the exact closed-loop hybrid encode, with ``refine`` recon
    rounds, the ``cold`` round's search ("i16" or "dense") and
    ``i4_topk`` (see ``encode_hybrid_core``); "wavefront" the exact
    full search, every mode decided inside the closed loop (the host
    encoder's decisions; ``refine``, ``cold`` and ``i4_topk`` change
    nothing); "openloop" the open-loop plane engine (fastest, lower
    quality: no segmentation, i16 modes only, prediction drift).
    ``depth`` chunks are in flight at once.

    Returns a list of complete .webp byte strings (order preserved).
    ``device`` None means CUDA (raises without it); "cpu" runs the
    kernels' plain versions with identical output.

    ``timings``, if given, gathers the call's spans (tracing.py) under
    "spans", per-stage milliseconds under "stage_ms" (device stages from
    CUDA events on a GPU, resolved once, as the call ends), and the
    spans' summed seconds: "prep" (``encode.prep``: a chunk's prep on its
    prep thread, which hands each image to the emission pool), "h2d"
    (``encode.h2d``: the main thread's upload, inside
    ``encode.dispatch``, its enqueue of the chunk), "fetch"
    (``encode.fetch``: the fetch thread's d2h), "emit_thread_s"
    (``encode.emit``: one an image) and "total" (``encode.call``).
    ``encode.wait`` marks the main thread blocked on a future, its
    ``stage`` attribute 0 for a prep, 1 for a fetch, 2 for the
    emissions.  Under ``torch.profiler`` the spans go to
    ``tracing.recorded()``.
    """
    check_engine(engine)
    check_hybrid_options(refine, cold, i4_topk)
    if not images:
        return []
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    openloop = engine == "openloop"
    rec = tracing.recorder("encode.call", timings, _SUMS)
    first = np.asarray(images[0])
    h, w = first.shape[:2]
    setup = encode_setup(quality, h, w, config)
    config, base_q, plan = setup["config"], setup["base_q"], setup["plan"]
    tables_np = _default_cost_tables()
    quants = dict(zip(("y1_dc", "y1_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac"),
                      (int(x) for x in setup["base_row"])))
    n = len(images)
    mh, mw = plan["mb_h"], plan["mb_w"]
    cap_s = plan["n_group_pad"] // 2
    cap_b = plan["n_group_pad"] // 4
    chunk = max(1, min(chunk, n))
    starts = list(range(0, n, chunk))
    ahead = max(1, depth)
    staging = StagingRing(ahead + 1, chunk,
                          plan["H"] * plan["W"] * 3 // 2, dev)
    side = torch.cuda.Stream(dev) if cuda else None

    def on_side():
        return torch.cuda.stream(side) if cuda else contextlib.nullcontext()

    def prep_one(im):
        return prep_image(im, setup, openloop=openloop)

    def prep_chunk(i, pool):
        """Host prep of chunk ``i`` into its staging buffer."""
        sp = rec.begin("encode.prep") if rec is not None else None
        s = starts[i]
        prepped = list(pool.map(prep_one, images[s:s + chunk]))
        slot = staging.slot(i)
        for j, p in enumerate(prepped):
            slot[j] = p[0]
        out = (len(prepped), [p[1] for p in prepped],
               np.stack([p[2] for p in prepped]),
               np.stack([p[3] for p in prepped]))
        if sp is not None:
            rec.end(sp, chunk=i, images=len(prepped))
        return out

    sticky = {"ks": min(FIRST_BUCKET, cap_s), "kb": min(FIRST_BUCKET, cap_b)}

    def dispatch(i, prepped, clock):
        """Main thread: enqueue chunk ``i``'s h2d, dense encode, pack and
        export at the sticky buckets; nothing here waits on the device."""
        nb, segs, qs, pens = prepped
        sp = rec.begin("encode.dispatch") if rec is not None else None
        sh = rec.begin("encode.h2d", sp) if rec is not None else None
        yd, ud, vd = split_planes(staging.upload(i, nb), plan)  # ONE h2d
        if sh is not None:
            rec.end(sh, chunk=i, h2d_bytes=yd.numel() + ud.numel()
                    + vd.numel())
        if clock is not None:
            clock("h2d")
        if openloop:
            out = planes_packed_step(yd, ud, vd, cap_s=cap_s, cap_b=cap_b,
                                     marks=clock, **quants)
        else:
            tables, qs_t, seg_t, pens_t = hybrid_params(segs, qs, pens, plan,
                                                        tables_np, dev)
            out = planes_wavefront_packed_step(
                yd, ud, vd, seg_t, qs_t, tables, cap_s=cap_s, cap_b=cap_b,
                i4_penalty=pens_t, try_i4=setup["try_i4"],
                use_derr=setup["use_derr"], refine=refine, cold=cold,
                i4_topk=i4_topk, marks=clock,
                search="closed" if engine == "wavefront" else "open")
        ks, kb = sticky["ks"], sticky["kb"]
        buf = _export_packed_v2(out, ks=ks, kb=kb)
        exported = None
        if cuda:
            exported = torch.cuda.Event()
            exported.record()
        if sp is not None:
            rec.end(sp, chunk=i)
        return out, buf, ks, kb, exported

    def download(buf, after=None):
        """d2h of an export buffer.  On CUDA: a side stream waits for the
        ``after`` event (recorded behind the export) and copies into
        pinned memory, so the d2h does not wait for device work enqueued
        since."""
        if not cuda:
            return buf.numpy()
        with on_side():
            if after is not None:
                side.wait_event(after)
            buf.record_stream(side)
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return host.numpy()

    t = plan["total"]
    n_mask = plan["n_group_pad"] // 4

    def fetch(out, buf, ks, kb, exported, clock):
        """Fetch thread: the d2h at the export's buckets; one re-export,
        at buckets grown to fit, when a chunk overflows them."""
        host = download(buf, exported)
        hdr = host[:, :12].copy().view(np.int32).reshape(-1, 3)
        need_ks = _bucket(max(1, int(hdr[:, 0].max())), cap_s)
        need_kb = _bucket(max(1, int(hdr[:, 1].max())), cap_b)
        if need_ks > ks or need_kb > kb:
            ks, kb = max(ks, need_ks), max(kb, need_kb)
            sticky["ks"] = max(sticky["ks"], ks)
            sticky["kb"] = max(sticky["kb"], kb)
            with on_side():          # behind the first copy's wait
                again = _export_packed_v2(out, ks=ks, kb=kb)
            host = download(again)
        if clock is not None:
            with on_side():
                clock("d2h")
        nb = host.shape[0]
        o = 12
        got = {"cs": hdr[:, 0], "cb": hdr[:, 1], "maxabs": hdr[:, 2]}
        got["mask2"] = host[:, o:o + n_mask]; o += n_mask
        got["small"] = host[:, o:o + ks * 2].reshape(nb, ks, 2); o += ks * 2
        got["big"] = host[:, o:o + kb * GROUP].view(np.int8).reshape(
            nb, kb, GROUP); o += kb * GROUP
        got["ymode"] = host[:, o:o + t]; o += t
        got["uvmode"] = host[:, o:o + t]; o += t
        if "is_i4" in out:
            got["is_i4"] = host[:, o:o + t]; o += t
            got["imodes"] = host[:, o:o + t * 16].reshape(nb, t, 16)
        else:                      # open-loop: every MB i16
            got["is_i4"] = np.zeros((nb, t), np.uint8)
            got["imodes"] = (None,) * nb
        return got

    def emit_one(gi, j, fetched, seg, dense):
        sp = rec.begin("encode.emit") if rec is not None else None
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
            if sp is not None:
                rec.end(sp, image=gi)

    def fetch_and_emit(i, segs, job, clock, pool):
        """Fetch thread: chunk ``i``'s d2h, then its emit submissions, in
        image order; an image that escapes the compact pack takes its
        dense levels (a d2h on the side stream too)."""
        out = job[0]
        sp = rec.begin("encode.fetch") if rec is not None else None
        got = fetch(*job, clock)
        if sp is not None:
            rec.end(sp, chunk=i)
        futs = []
        for j, seg in enumerate(segs):
            dense = None
            if (got["maxabs"][j] > 127 or got["cs"][j] > cap_s
                    or got["cb"][j] > cap_b):
                with on_side():
                    dense = (out["y2_levels"][j].cpu().numpy().reshape(t, 16),
                             out["y_levels"][j].cpu().numpy().reshape(t, 16, 16),
                             out["uv_levels"][j].cpu().numpy().reshape(t, 8, 16))
            gi = starts[i] + j
            futs.append((gi, pool.submit(emit_one, gi, j, got, seg, dense)))
        return futs

    def wait(fut, k: int, stage: int):
        """The main thread blocked on ``fut``: chunk ``k``'s prep (stage
        0), fetch (1) or an emission (2)."""
        sp = rec.begin("encode.wait") if rec is not None else None
        got = fut.result()
        if sp is not None:
            rec.end(sp, chunk=k, stage=stage)
        return got

    results = [None] * n
    with cf.ThreadPoolExecutor(max_workers=max(1, threads)) as pool, \
            cf.ThreadPoolExecutor(max_workers=2) as prep_pool, \
            cf.ThreadPoolExecutor(max_workers=1) as fetch_pool:
        emit_futs = []
        pending = deque()
        preps = deque(prep_pool.submit(prep_chunk, i, pool)
                      for i in range(min(ahead, len(starts))))
        for i in range(len(starts)):
            prepped = wait(preps.popleft(), i, 0)
            if i + ahead < len(starts):
                preps.append(prep_pool.submit(prep_chunk, i + ahead, pool))
            clock = rec.clock(dev) if rec is not None else None
            job = dispatch(i, prepped, clock)
            pending.append((i, fetch_pool.submit(fetch_and_emit, i,
                                                 prepped[1], job, clock,
                                                 pool)))
            while len(pending) >= ahead:
                k, fut = pending.popleft()
                emit_futs.extend(wait(fut, k, 1))
        while pending:
            k, fut = pending.popleft()
            emit_futs.extend(wait(fut, k, 1))
        for gi, fut in emit_futs:
            results[gi] = wait(fut, gi // chunk, 2)
    if rec is not None:
        rec.finish(images=n, chunks=len(starts))
    return results


__all__ = [
    "StagingRing",
    "check_engine",
    "check_hybrid_options",
    "encode_rgba_batch_pipelined",
    "encode_setup",
    "hybrid_params",
    "planes_packed_step",
    "planes_wavefront_packed_step",
    "prep_image",
    "split_planes",
    "stack_prepped",
    "unpack_g4v2",
]
