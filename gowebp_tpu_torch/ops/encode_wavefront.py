"""Hybrid closed-loop VP8 dense encode: parallel mode search + wavefront.

The hybrid engine splits the encoder's work in two:

- ``openloop_mode_search`` decides every macroblock's modes (i16 mode,
  per-sub-block i4 modes, i4-vs-i16 adoption, uv mode) for all MBs of
  all images at once, with prediction context read from a plane — the
  source on the cold round, the previous round's reconstruction on a
  refine round.  A refine round walks each MB's 16 sub-blocks
  (Gauss-Seidel: each winner's recon is the context of the sub-blocks
  after it), scoring the 10 B-modes of each (or the ``i4_topk``
  best-predicting), in one launch of the i4 walk kernel
  (ops/kernels/i4_search.py).  The cold round of ``cold="dense"``
  scores every sub-block of every MB independently from plane context,
  in one launch of the flat i4 search kernel.
- ``encode_wavefront_core`` codes the MBs with those modes exactly
  closed-loop, in anti-diagonal order, with the wavefront kernel
  (ops/kernels/wavefront_fixed.py), so the stream has zero prediction
  drift whatever modes won.

Every function routes by the device of its tensors: the kernels on
CUDA, their plain torch versions on the CPU.  All arithmetic is exact
int32 and bit-identical to the host encoder's decisions under the same
context.
"""

from __future__ import annotations

import torch

from ..models.vp8.encoder import I4_PENALTY_MAX
from . import dct
from .dct import BIAS
from .kernels.encode_plane import encode_modes
from .kernels.i4_search import i4_search, i4_walk, t3_tables
from .kernels.wavefront_fixed import wavefront_fixed
from .kernels.wavefront_search import search_tables, wavefront_search
from .rate import block_rate256, mul_shr16
from .vp8_recon import mb_context, predict4_blocks

I32 = torch.int32


def _sse(a, b, dims):
    d = a.to(I32) - b.to(I32)
    return (d * d).sum(dim=dims, dtype=I32)


def _per_mb(table, seg):
    """(B, 4, ...) per-segment rows → (B, N, ...) per-MB rows."""
    B = table.shape[0]
    return table[torch.arange(B, device=seg.device)[:, None], seg]


def openloop_mode_search(y, u, v, seg_map, qsteps, tables, *, try_i4: bool,
                         i4_penalty, ctx=None, i4_parallel: bool = False,
                         i4_topk=None):
    """Parallel mode search for all MBs with plane prediction context.

    y (B, H, W), u/v (B, H/2, W/2) int32-valued planes (H, W multiples
    of 16); seg_map (B, mh, mw) int32; qsteps (B, 4, 6) int32; tables
    the (p0, p1, val) int32 cost tables; i4_penalty a (B, 4) int32
    tensor of per-segment RD lambdas.  ``ctx`` (refine rounds): a
    (recon_y, recon_u, recon_v) tuple whose pixels replace the source
    as prediction context, while distortion stays against the source.
    ``i4_parallel`` scores the sub-blocks independently from plane
    context (``_i4_search_parallel``) instead of the within-MB walk;
    ``i4_topk`` keeps the k best-predicting B-modes of each sub-block.
    Without ``try_i4`` and ``ctx`` (the hybrid's cold round) the modes
    are the open-loop plane kernels' (``encode_modes``, one launch of
    each modes-only kernel on CUDA).

    Returns dense (B, mh, mw[, 16]) int32 ymode/uvmode/is_i4/imodes.
    """
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    N = mh * mw
    dev = y.device
    if not try_i4 and ctx is None:
        U8 = torch.uint8
        ymode, uvmode = (m.to(I32) for m in encode_modes(
            y.to(U8), u.to(U8), v.to(U8)))
        return {
            "ymode": ymode, "uvmode": uvmode,
            "is_i4": torch.zeros((B, mh, mw), dtype=I32, device=dev),
            "imodes": ymode[..., None].expand(B, mh, mw, 16).contiguous(),
        }
    cy, cu, cv = (c.to(I32) for c in (ctx if ctx is not None else (y, u, v)))

    qs = qsteps.to(I32)
    iqs = (1 << 17) // qs.clamp_min(1)
    seg = seg_map.reshape(B, N).long()
    qlane = _per_mb(qs, seg)                                   # (B, N, 6)
    iqlane = _per_mb(iqs, seg)

    # ---- MB-level context (exact engine edge conventions) ----
    src = y.to(I32).reshape(B, mh, 16, mw, 16).permute(0, 1, 3, 2, 4)
    src = src.reshape(B, N, 16, 16)
    top16, tr4, left16, tlpx, ht, hl = mb_context(cy, mh, mw, 16)

    # ---- i16 candidate ----
    pred4 = predict4_blocks(top16, left16, tlpx, ht, hl, 16)  # (4,B,N,16,16)
    ymode = torch.argmin(_sse(src[None], pred4, (-1, -2)), dim=0).to(I32)
    bidx = torch.arange(B, device=dev)[:, None]
    nidx = torch.arange(N, device=dev)[None, :]
    pred = pred4[ymode.long(), bidx, nidx]                     # (B,N,16,16)

    is4 = torch.zeros((B, N), dtype=I32, device=dev)
    imodes = ymode[..., None].expand(B, N, 16)
    if try_i4:
        blk = (src - pred).reshape(B, N, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5)
        coeffs = dct.fdct4x4(blk)
        y2 = dct.fwht4x4(coeffs[..., 0, 0])
        y2_levels = dct.quantize(y2, iqlane[..., 2], BIAS["y2_dc"],
                                 iqlane[..., 3], BIAS["y2_ac"])
        y_levels = dct.quantize(
            coeffs.reshape(B, N, 16, 4, 4), iqlane[..., 0:1], BIAS["y1_dc"],
            iqlane[..., 1:2], BIAS["y1_ac"], first_ac=True)
        # open-loop i16 reconstruction for the score's distortion term
        y2_deq = dct.dequantize(y2_levels, qlane[..., 2], qlane[..., 3])
        any_ac = (y2_levels[..., 1:] != 0).any(dim=-1)
        dc_only = ((y2_deq[..., 0, 0] + 3) >> 3)[..., None, None]
        rdcs = torch.where(any_ac[..., None, None], dct.iwht4x4(y2_deq),
                           dc_only)
        deq = dct.dequantize(y_levels, qlane[..., 0:1], qlane[..., 1:2])
        deq = deq.reshape(B, N, 4, 4, 4, 4).clone()
        deq[..., 0, 0] = rdcs
        pred_blk = pred.reshape(B, N, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5)
        recon16 = dct.idct_add_clip(deq, pred_blk).permute(
            0, 1, 2, 4, 3, 5).reshape(B, N, 16, 16)
        d16 = _sse(src, recon16, (-1, -2))
        rate16 = block_rate256(y2_levels, tables, type=1, first=0, ctx0=1)
        rate16 = rate16 + block_rate256(
            y_levels, tables, type=0, first=1, ctx0=1).sum(dim=-1, dtype=I32)
        pen_n = _per_mb(i4_penalty.to(I32), seg)
        s16 = d16 + mul_shr16(pen_n, rate16)
        t3 = t3_tables(tables)
        if i4_parallel:
            bmodes, s4 = _i4_search_parallel(y, cy, qlane, iqlane, pen_n, t3,
                                             i4_topk)
        else:
            bmodes, s4 = _i4_gauss_seidel(src, top16, tr4, left16, tlpx,
                                          qlane, iqlane, pen_n, t3, i4_topk)
        adopt = s4 < s16
        is4 = adopt.to(I32)
        imodes = torch.where(adopt[..., None], bmodes, imodes)

    # ---- chroma: joint U+V SSE argmin over DC/TM/VE/HE ----
    sse_uv = 0
    for p, cp in ((u, cu), (v, cv)):
        blocks = p.to(I32).reshape(B, mh, 8, mw, 8).permute(0, 1, 3, 2, 4)
        t8, _, l8, tl8, _, _ = mb_context(cp, mh, mw, 8)
        cpred4 = predict4_blocks(t8, l8, tl8, ht, hl, 8)
        sse_uv = sse_uv + _sse(blocks.reshape(B, N, 8, 8)[None], cpred4,
                               (-1, -2))
    uvmode = torch.argmin(sse_uv, dim=0).to(I32)

    return {
        "ymode": ymode.reshape(B, mh, mw),
        "uvmode": uvmode.reshape(B, mh, mw),
        "is_i4": is4.reshape(B, mh, mw),
        "imodes": imodes.reshape(B, mh, mw, 16).contiguous(),
    }


def _i4_gauss_seidel(src, top16, tr4, left16, tlpx, qlane, iqlane, pen_n,
                     t3, topk=None):
    """The 16-substep within-MB i4 walk over every MB at once: one
    ``i4_walk`` launch on CUDA tensors, its plain version on CPU tensors.

    Returns (bmodes (B, N, 16), summed RD score s4 (B, N)).
    """
    return i4_walk(*(t.contiguous() for t in (src, top16, tr4, left16, tlpx,
                                              qlane, iqlane, pen_n)), t3,
                   topk=topk)


def plane_i4_inputs(y, cy, qlane, iqlane, pen_n):
    """The flat i4 search's rows for every 4x4 sub-block, its context read
    from the plane ``cy``.

    Edge rules, as the closed-loop engine's: the top row of the frame is
    127 (its top-left corner included), column 0 is 129, and a sub-block
    with gx == 3 takes the MB's top-right pixels (the row above the MB,
    repeated from that row's last pixel in the last MB column, 127 in the
    top MB row).  y (B, H, W) source; cy (B, H, W) int32 context;
    qlane/iqlane (B, N, 6) and pen_n (B, N) per-MB quantizers and
    lambdas.  Returns (ctx13 (S, 13), src16 (S, 16), quants5 (S, 5))
    int32, one row per sub-block in (image, sub-block row, column) order.
    """
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    sh, sw = H // 4, W // 4
    dev = y.device
    sy = torch.arange(sh, device=dev)
    sx = torch.arange(sw, device=dev)
    above = cy[:, (4 * sy - 1).clamp_min(0)]                  # (B, sh, W)
    top = above.reshape(B, sh, sw, 4)
    tl = above[:, :, (4 * sx - 1).clamp_min(0)]               # (B, sh, sw)
    tr_cols = (4 * sx[:, None] + 4 + torch.arange(4, device=dev)).clamp_max(
        W - 1)
    tr = above[:, :, tr_cols]                                 # (B, sh, sw, 4)
    tr4 = mb_context(cy, mh, mw, 16)[1].reshape(B, mh, 1, mw, 1, 4)
    tr = torch.where(((sx & 3) == 3)[:, None],
                     tr4.expand(B, mh, 4, mw, 4, 4).reshape(B, sh, sw, 4), tr)
    left = cy[:, :, (4 * sx - 1).clamp_min(0)].reshape(
        B, sh, 4, sw).transpose(2, 3)                         # (B, sh, sw, 4)
    at_top = (sy == 0)[:, None]
    at_left = sx == 0
    top = torch.where(at_top[..., None], 127, top)
    tr = torch.where(at_top[..., None], 127, tr)
    left = torch.where(at_left[:, None], 129, left)
    tl = torch.where(at_top, 127, torch.where(at_left, 129, tl))
    ctx13 = torch.cat([tl[..., None], top, tr, left], dim=-1)
    src16 = y.to(I32).reshape(B, sh, 4, sw, 4).permute(0, 1, 3, 2, 4)
    q5 = torch.cat([iqlane[..., :2], qlane[..., :2], pen_n[..., None]], -1)
    quants5 = q5.reshape(B, mh, 1, mw, 1, 5).expand(B, mh, 4, mw, 4, 5)
    return tuple(t.reshape(B * sh * sw, -1).to(I32).contiguous()
                 for t in (ctx13, src16, quants5))


def _i4_search_parallel(y, cy, qlane, iqlane, pen_n, t3, topk=None):
    """Every 4x4 sub-block's i4 search at once, from PLANE context.

    The cold round's context is approximate anyway (the source), so each
    sub-block reads its neighbours straight from the context plane
    (``plane_i4_inputs``) instead of from the within-MB walk: one flat
    ``i4_search`` launch over all B * H * W / 16 sub-blocks (its plain
    version on CPU tensors).  Returns (bmodes (B, N, 16) in MB raster
    order, summed RD score s4 (B, N)) int32.
    """
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    bmode, cost, _ = i4_search(*plane_i4_inputs(y, cy, qlane, iqlane, pen_n),
                               t3, topk=topk)

    def per_mb(a):
        """(B * H * W / 16,) sub-block values → (B, N, 16), MB raster."""
        return a.reshape(B, mh, 4, mw, 4).permute(0, 1, 3, 2, 4).reshape(
            B, mh * mw, 16)

    return per_mb(bmode), per_mb(cost).sum(dim=-1, dtype=I32)


def encode_wavefront_core(y, u, v, seg_map, qsteps, tables=None, *,
                          modes=None, try_i4: bool = False, i4_penalty=None,
                          want_recon: bool = False, use_derr: bool = False,
                          trellis=None):
    """Exact closed-loop encode of every MB, in anti-diagonal order.

    y (B, H, W) and u/v (B, H/2, W/2) planes (uint8, or int32 holding
    0..255); seg_map (B, mh, mw) int32; qsteps (B, 4, 6) int32.

    ``modes`` = (ymode, uvmode, is_i4, imodes) dense int32: code every MB
    with the modes given (the hybrid engine's wavefront passes; the
    wavefront kernel).  ``modes`` None: the exact engine, which searches
    every MB's modes inside the loop (the full-search kernel), with the
    i4 search when ``try_i4`` (``tables`` the (p0, p1, val) cost tables,
    ``i4_penalty`` a (B, 4) int32 tensor of per-segment RD lambdas).
    ``trellis`` (with ``modes`` None), a (B, 4) int32 tensor of
    per-segment trellis lambdas, runs the search's trellis form (the host
    encoder's second pass at method 6): every block's levels are
    trellis-refined, and ``tables`` (then needed even without ``try_i4``)
    are the first pass's adapted cost tables, the rate model of both the
    search and the trellis.
    Runs the kernel on CUDA tensors and its plain version on CPU tensors.

    Returns uint8 ymode/uvmode/is_i4/imodes (imodes = ymode repeated
    for i16 MBs), int16 y_levels (B, mh, mw, 16, 16), y2_levels
    (B, mh, mw, 16), uv_levels (B, mh, mw, 8, 16), and with
    ``want_recon`` the uint8 recon planes recon_y/recon_u/recon_v.
    """
    U8 = torch.uint8
    planes = tuple(p.to(U8).contiguous() for p in (y, u, v))
    seg_map, qsteps = (t.to(I32).contiguous() for t in (seg_map, qsteps))
    if modes is None:
        pens = rate = lams = None
        if try_i4:
            pens = i4_penalty.to(I32).contiguous()
        if trellis is not None:
            lams = trellis.to(I32).contiguous()
        if try_i4 or trellis is not None:
            rate = search_tables(tables, trellis=trellis is not None)
        return wavefront_search(*planes, seg_map, qsteps, pens, rate,
                                try_i4=try_i4, use_derr=use_derr,
                                want_recon=want_recon, lams=lams)
    ymode, uvmode, is_i4, imodes = (m.to(I32).contiguous() for m in modes)
    out = wavefront_fixed(*planes, seg_map, qsteps, ymode, uvmode, is_i4,
                          imodes, use_derr=use_derr, want_recon=want_recon)
    adopt = is_i4 != 0
    out.update(
        ymode=ymode.to(U8), uvmode=uvmode.to(U8), is_i4=adopt.to(U8),
        imodes=torch.where(adopt[..., None], imodes,
                           ymode[..., None]).to(U8))
    return out


def search_penalty(i4_penalty: torch.Tensor) -> torch.Tensor:
    """The hybrid search's RD lambda: 7/4 x the engine's, capped < 2^19.

    The parallel (Jacobi) search evaluates candidates against
    approximate context, which understates the true coding rate on
    textured content; scaling the SEARCH lambda by 7/4 recenters its
    decisions.  The emitted stream is exact closed-loop for whatever
    modes win, so this only moves the decisions.
    """
    return torch.clamp_max((i4_penalty.to(I32) * 7) >> 2, I4_PENALTY_MAX)


def encode_hybrid_core(y, u, v, seg_map, qsteps, tables, *, i4_penalty,
                       try_i4: bool = True, refine: int = 1,
                       cold: str = "i16", i4_topk=None,
                       use_derr: bool = False, marks=None):
    """Hybrid engine: a cold mode search, then ``refine`` rounds of a
    wavefront pass with recon followed by a search with the Gauss-Seidel
    i4 walk from that recon, then the final wavefront pass.

    i4_penalty: (B, 4) int32 per-segment RD lambdas of the closed-loop
    engine; every search uses 7/4 of them (``search_penalty``).
    ``cold`` picks the cold round's search when ``refine`` > 0: "i16"
    decides no i4 modes (its only job is to seed the recon context; the
    refine round re-decides every mode), "dense" runs the plane-context
    i4 search of every sub-block.  With ``refine`` = 0 the cold round is
    the final search and walks the i4 sub-blocks.  ``try_i4`` False
    searches no i4 mode anywhere; ``i4_topk`` keeps the k best-predicting
    B-modes in every i4 search.  ``marks``, if given, is called with a
    stage name after each stage is enqueued: "cold", then "wavefront1",
    "refine", "wavefront2", "refine2", "wavefront3", ...
    """
    mark = marks if marks is not None else (lambda name: None)
    pen_search = search_penalty(i4_penalty)
    modes = openloop_mode_search(
        y, u, v, seg_map, qsteps, tables,
        try_i4=try_i4 and not (cold == "i16" and refine > 0),
        i4_penalty=pen_search, i4_parallel=refine > 0, i4_topk=i4_topk)
    mark("cold")
    order = ("ymode", "uvmode", "is_i4", "imodes")
    for r in range(refine + 1):
        last = r == refine
        out = encode_wavefront_core(
            y, u, v, seg_map, qsteps, modes=tuple(modes[k] for k in order),
            want_recon=not last, use_derr=use_derr)
        mark(f"wavefront{r + 1}")
        if not last:
            modes = openloop_mode_search(
                y, u, v, seg_map, qsteps, tables, try_i4=try_i4,
                i4_penalty=pen_search, i4_topk=i4_topk,
                ctx=(out["recon_y"], out["recon_u"], out["recon_v"]))
            mark("refine" if r == 0 else f"refine{r + 1}")
    return out


__all__ = ["encode_hybrid_core", "encode_wavefront_core",
           "openloop_mode_search", "plane_i4_inputs", "search_penalty"]
