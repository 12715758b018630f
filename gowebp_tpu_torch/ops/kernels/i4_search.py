"""i4 candidate search: the Hopper kernels, their bindings and plain versions.

``i4_search`` scores all 10 B-modes of S independent 4x4 luma
sub-blocks and returns, per sub-block, the RD-argmin mode, its cost and
its 16 reconstructed pixels.  On a CUDA tensor it launches the kernel in
``i4_search.cu`` (replacing the TPU kernel
gowebp_tpu/ops/pallas/i4_search.py); on a CPU tensor it runs
``i4_search_plain``, the same arithmetic as vectorised torch ops.

``i4_walk`` runs the hybrid refine round's whole 16-substep Gauss-Seidel
walk over every MB in one launch (each substep's winning recon is the
next sub-blocks' context); ``i4_walk_plain`` is the same walk as 16
``i4_search_plain`` calls in raster order.

``topk`` (both): score only the k best-predicting B-modes of each
sub-block, ranked by the prediction's SSE against the source with ties
to the lower mode; the RD argmin then takes the first minimum in RANK
order, so a cost tie goes to the better-predicting mode (``topk=10``
differs from ``None`` there).  The SSE is below 16 * 255**2 < 2**24, so
the key ``sse * 16 + mode`` is exact and unique.

Layout, one row per sub-block:
  ctx13   (S, 13) int32  [tl, top0-3, tr0-3, left0-3]
  src16   (S, 16) int32  raster source pixels
  quants5 (S, 5)  int32  [iq_dc, iq_ac, q_dc, q_ac, pen]
  t3      the type-3 (i4 luma) rate tables by position:
          p0 (16, 3, 2), p1 (16, 3, 2), val (16, 3, 68) int32
"""

from __future__ import annotations

import ctypes

import torch

from ..dct import BIAS, dequantize, fdct4x4, idct_add_clip, quantize
from ..rate import (mul_shr16, position_tables, rate_by_position,
                    trellis_refine)
from ..vp8_recon import _pred_luma4_all
from .cuda_build import CudaLibrary, check_tensor, stream_handle

I32 = torch.int32

MODE4_BITS256 = (256, 704, 768, 768, 960, 1024, 960, 1024, 1024, 960)


def _configure(lib) -> None:
    p = ctypes.c_void_p
    lib.i4_search_launch.restype = ctypes.c_int
    lib.i4_search_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int,
                                     ctypes.c_int, p, p, p, p]
    lib.i4_walk_launch.restype = ctypes.c_int
    lib.i4_walk_launch.argtypes = [p] * 11 + [ctypes.c_int] * 2 + [p] * 4


LIBRARY = CudaLibrary("i4_search.cu", _configure)


def t3_tables(tables):
    """(p0, p1, val) cost tables → the type-3 per-position rows ``t3``."""
    return position_tables(tables, 3)


def check_topk(topk) -> None:
    """Raise unless ``topk`` is None or an int in 1..10."""
    if topk is None:
        return
    if isinstance(topk, bool) or not isinstance(topk, int):
        raise TypeError(f"topk must be None or an int, got {type(topk)}")
    if not 1 <= topk <= 10:
        raise ValueError(f"topk must be in 1..10, got {topk}")


def rank_modes(preds, src, topk: int):
    """The ``topk`` best-predicting B-modes: preds (S, 10, 4, 4), src
    (S, 1, 4, 4) → mode ids (S, topk), best first, ties to the lower
    mode."""
    d = src - preds
    key = (d * d).sum(dim=(-1, -2), dtype=I32) * 16 + torch.arange(
        10, dtype=I32, device=preds.device)
    return torch.sort(key, dim=-1).indices[:, :topk]


def i4_search_plain(ctx13, src16, quants5, t3, topk=None, lam=None):
    """Vectorised torch version of the kernel (any device).

    ``lam`` (S,) int, if given, trellis-refines each candidate's levels
    (``trellis_refine`` on ``t3``, lambda ``lam``) before it is scored:
    the exact engine's trellis pass.  Returns (bmode (S,) int32, cost (S,)
    int32, rec (S, 16) uint8).
    """
    S = ctx13.shape[0]
    ctx13 = ctx13.to(I32)
    tl, top, tr, left = ctx13[:, 0], ctx13[:, 1:5], ctx13[:, 5:9], ctx13[:, 9:13]
    src = src16.to(I32).reshape(S, 1, 4, 4)
    q = quants5.to(I32)
    preds = _pred_luma4_all(tl, top, tr, left)                 # (S,10,4,4)
    rows = torch.arange(S, device=preds.device)
    ids = torch.arange(10, device=preds.device).expand(S, 10)
    if topk is not None:                     # candidates in rank order
        ids = rank_modes(preds, src, topk)
        preds = preds[rows[:, None], ids]                      # (S,k,4,4)
    cf = fdct4x4(src - preds)
    lv = quantize(cf, q[:, 0:1], BIAS["y1_dc"], q[:, 1:2],
                  BIAS["y1_ac"])                              # (S,k,16)
    if lam is not None:
        k = lv.shape[1]

        def rep(t):
            return t[:, None].expand(S, k).reshape(-1)

        lv = trellis_refine(lv.reshape(-1, 16), cf.reshape(-1, 16), *t3,
                            first=0, ctx0=1, dc_q=rep(q[:, 2]),
                            ac_q=rep(q[:, 3]), lam=rep(lam)).reshape(lv.shape)
    rec = idct_add_clip(dequantize(lv, q[:, 2:3], q[:, 3:4]), preds)
    d = src - rec
    dist = (d * d).sum(dim=(-1, -2), dtype=I32)
    rate = rate_by_position(lv, *t3, first=0, ctx0=1)
    bits = torch.tensor(MODE4_BITS256, dtype=I32, device=lv.device)[ids]
    cost = dist + mul_shr16(q[:, 4:5], rate + bits)
    kidx = torch.argmin(cost, dim=-1)        # first minimum in candidate order
    brec = rec[rows, kidx].reshape(S, 16).to(torch.uint8)
    return ids[rows, kidx].to(I32), cost[rows, kidx], brec


def i4_search(ctx13, src16, quants5, t3, topk=None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor.

    ``i4_search.launches`` counts kernel launches (one per call on CUDA).
    """
    check_topk(topk)
    dev = ctx13.device
    if dev.type == "cpu":
        return i4_search_plain(ctx13, src16, quants5, t3, topk)
    if dev.type != "cuda":
        raise ValueError(f"i4_search: unsupported device {dev}")
    S = ctx13.shape[0]
    check_tensor("ctx13", ctx13, I32, (S, 13), dev)
    check_tensor("src16", src16, I32, (S, 16), dev)
    check_tensor("quants5", quants5, I32, (S, 5), dev)
    for name, tab, shape in zip(("p0", "p1", "val"), t3,
                                ((16, 3, 2), (16, 3, 2), (16, 3, 68))):
        check_tensor(name, tab, I32, shape, dev)
    lib = LIBRARY.load()
    bmode = torch.empty(S, dtype=I32, device=dev)
    cost = torch.empty(S, dtype=I32, device=dev)
    rec = torch.empty((S, 16), dtype=torch.uint8, device=dev)
    err = lib.i4_search_launch(
        ctx13.data_ptr(), src16.data_ptr(), quants5.data_ptr(),
        t3[0].data_ptr(), t3[1].data_ptr(), t3[2].data_ptr(), S, topk or 0,
        bmode.data_ptr(), cost.data_ptr(), rec.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"i4_search kernel launch failed: CUDA error {err}")
    i4_search.launches += 1
    return bmode, cost, rec


i4_search.launches = 0


def i4_walk_plain(src, top16, tr4, left16, tl, qlane, iqlane, pen, t3, *,
                  want_recon: bool = False, topk=None, search=i4_search_plain,
                  lam=None):
    """The 16-substep within-MB i4 walk over every MB at once (any device).

    src (B, N, 16, 16) int32 source MBs; top16 (B, N, 16), tr4 (B, N, 4),
    left16 (B, N, 16), tl (B, N) int32 context pixels; qlane/iqlane
    (B, N, 6) int32 per-MB quantizer steps and their reciprocals; pen
    (B, N) int32 RD lambdas; t3 the type-3 rate tables.  The scratch
    mirrors the closed-loop engine's (17, 21) border: row 0 = [tl, top16,
    tr4], column 0 = left16, the interior filled with each substep's
    winning recon.  Sub-blocks with gx == 3 take their top-right pixels
    from the MB's tr4.  Returns (bmodes (B, N, 16), summed RD score
    s4 (B, N)) int32, and with ``want_recon`` the winners' recon (B, N,
    16, 16) uint8.  ``search`` scores each substep's B*N sub-blocks
    (``i4_search`` makes the walk 16 launches of the flat kernel).
    ``lam`` (B, N), if given, is ``i4_search_plain``'s trellis lambda.
    """
    B, N = src.shape[:2]
    dev = src.device
    scr = torch.zeros((B, N, 17, 21), dtype=I32, device=dev)
    scr[:, :, 0, 0] = tl
    scr[:, :, 0, 1:17] = top16
    scr[:, :, 0, 17:21] = tr4
    scr[:, :, 1:17, 0] = left16
    quants5 = torch.stack([iqlane[..., 0], iqlane[..., 1], qlane[..., 0],
                           qlane[..., 1], pen], dim=-1).reshape(B * N, 5)
    bmodes = torch.zeros((B, N, 16), dtype=I32, device=dev)
    s4 = torch.zeros((B, N), dtype=I32, device=dev)
    for n in range(16):
        gy, gx = n >> 2, n & 3
        r, c = 4 * gy, 4 * gx
        tr = scr[:, :, 0, 17:21] if gx == 3 else scr[:, :, r, c + 5:c + 9]
        ctx13 = torch.cat([scr[:, :, r, c:c + 5], tr,
                           scr[:, :, r + 1:r + 5, c]], dim=-1)
        src16 = src[:, :, r:r + 4, c:c + 4].reshape(B * N, 16)
        extra = () if lam is None else (lam.reshape(B * N),)
        bmode, bcost, brec = search(ctx13.reshape(B * N, 13), src16,
                                    quants5, t3, topk, *extra)
        scr[:, :, r + 1:r + 5, c + 1:c + 5] = brec.reshape(B, N, 4, 4)
        bmodes[:, :, n] = bmode.reshape(B, N)
        s4 += bcost.reshape(B, N)
    if want_recon:
        return bmodes, s4, scr[:, :, 1:17, 1:17].to(torch.uint8)
    return bmodes, s4


def i4_walk(src, top16, tr4, left16, tl, qlane, iqlane, pen, t3, *,
            want_recon: bool = False, topk=None):
    """Kernel on CUDA tensors, ``i4_walk_plain`` on CPU tensors.

    ``i4_walk.launches`` counts kernel launches (one per call on CUDA).
    """
    check_topk(topk)
    dev = src.device
    if dev.type == "cpu":
        return i4_walk_plain(src, top16, tr4, left16, tl, qlane, iqlane, pen,
                             t3, want_recon=want_recon, topk=topk)
    if dev.type != "cuda":
        raise ValueError(f"i4_walk: unsupported device {dev}")
    B, N = src.shape[:2]
    check_tensor("src", src, I32, (B, N, 16, 16), dev)
    for name, tns, shape in (("top16", top16, (B, N, 16)),
                             ("tr4", tr4, (B, N, 4)),
                             ("left16", left16, (B, N, 16)),
                             ("tl", tl, (B, N)), ("qlane", qlane, (B, N, 6)),
                             ("iqlane", iqlane, (B, N, 6)),
                             ("pen", pen, (B, N))):
        check_tensor(name, tns, I32, shape, dev)
    for name, tab, shape in zip(("p0", "p1", "val"), t3,
                                ((16, 3, 2), (16, 3, 2), (16, 3, 68))):
        check_tensor(name, tab, I32, shape, dev)
    lib = LIBRARY.load()
    bmodes = torch.empty((B, N, 16), dtype=I32, device=dev)
    s4 = torch.empty((B, N), dtype=I32, device=dev)
    rec = (torch.empty((B, N, 16, 16), dtype=torch.uint8, device=dev)
           if want_recon else None)
    err = lib.i4_walk_launch(
        *(t.data_ptr() for t in (src, top16, tr4, left16, tl, qlane, iqlane,
                                 pen) + tuple(t3)),
        B * N, topk or 0, bmodes.data_ptr(), s4.data_ptr(),
        rec.data_ptr() if want_recon else None, stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"i4_walk kernel launch failed: CUDA error {err}")
    i4_walk.launches += 1
    return (bmodes, s4, rec) if want_recon else (bmodes, s4)


i4_walk.launches = 0

__all__ = ["LIBRARY", "check_topk", "i4_search", "i4_search_plain",
           "i4_walk", "i4_walk_plain", "rank_modes", "t3_tables"]
