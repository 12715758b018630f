"""PyTorch port: the orders the Hopper kernels run in, checked on CPU.

- The i4 walk in sub-block diagonal order (d = 2*gy + gx, the order of
  ``i4_walk``'s kernel) gives the same modes, scores and recon as
  ``i4_walk_plain``'s raster order.
- The fixed-i4 chain in that diagonal order (the order of
  ``wavefront_fixed``'s kernel) gives the same levels and recon as
  ``wavefront_fixed_plain``.
- The persistent wavefront's schedule (rows claimed by ticket, row by row
  across the batch; MB (my, mx) after row my-1 has published
  min(mx + 2, mw) MBs) honours every dependency the plain version reads,
  and finishes with any number of resident blocks; the full-search kernel
  keeps that schedule.
- The full-search kernel's MB step: its i4 walk in diagonal order, with
  each step's winner's levels taken from its own step's context, gives the
  plain full search's modes, recon and levels.
"""

import re

import numpy as np
import pytest
import torch

from gowebp_tpu.models.vp8.encoder import (_default_cost_tables, _i4_config,
                                           make_quants, quality_to_q)
from gowebp_tpu_torch.ops.dct import (BIAS, dequantize, fdct4x4,
                                      idct_add_clip, quantize)
from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
from gowebp_tpu_torch.ops.kernels.i4_search import (i4_search_plain,
                                                    i4_walk_plain, t3_tables)
from gowebp_tpu_torch.ops.kernels.wavefront_fixed import wavefront_fixed_plain
from gowebp_tpu_torch.ops.vp8_recon import _pred_luma4_all, mb_context

I32 = torch.int32


def kernel_diagonals():
    """The sub-blocks (gy, gx) of each step d, as the CUDA kernels pick
    them: segment h takes gy = gy0 + h, gx = d - 2*gy where that exists."""
    steps = []
    for d in range(10):
        gy0 = 0 if d < 3 else (d - 2) >> 1
        step = []
        for h in range(2):
            gy, gx = gy0 + h, d - 2 * (gy0 + h)
            if gy <= 3 and 0 <= gx <= 3:
                step.append((gy, gx))
        steps.append(step)
    return steps


def test_kernel_diagonals_are_the_anti_diagonals():
    want = [[(gy, gx) for gy in range(4) for gx in range(4)
             if 2 * gy + gx == d] for d in range(10)]
    assert kernel_diagonals() == want
    done = set()
    for step in kernel_diagonals():
        for gy, gx in step:
            # left, top, top-left and top-right (gx < 3) on earlier steps
            deps = [(gy, gx - 1), (gy - 1, gx), (gy - 1, gx - 1)]
            if gx < 3:
                deps.append((gy - 1, gx + 1))
            for dy, dx in deps:
                if dy >= 0 and 0 <= dx <= 3:
                    assert (dy, dx) in done
        done.update(step)
    assert len(done) == 16


def _walk_case(seed, quality, B=2, N=12):
    """Seeded walk inputs: smooth and noisy MBs, 4 segments' quantizers."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:16, 0:16]
    src = rng.integers(0, 256, (B, N, 16, 16))
    src[:, ::2] = np.clip(120 + 50 * np.sin(xx / 3.0 + yy / 5.0)
                          + rng.integers(-3, 4, (B, N // 2 + N % 2, 16, 16)),
                          0, 255)
    rows = []
    for d in (-6, -2, 3, 8):
        q = make_quants(max(0, min(127, quality_to_q(quality) + d)))
        rows.append([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q,
                     q.uv_ac.q])
    rows = np.array(rows, np.int32)
    seg = rng.integers(0, 4, (B, N))
    qlane = rows[seg]
    iqlane = (1 << 17) // qlane
    _, pen = _i4_config(int(rows[0, 1]), 4, 0)
    pens = rng.integers(pen // 2, 2 * pen + 1, (B, N))
    ctx = [rng.integers(0, 256, s) for s in ((B, N, 16), (B, N, 4),
                                             (B, N, 16), (B, N))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))  # noqa: E731
    return (t(src), *(t(c) for c in ctx), t(qlane), t(iqlane), t(pens))


def _diagonal_walk(src, top16, tr4, left16, tl, qlane, iqlane, pen, t3,
                   want_levels=False):
    """The walk of i4_walk_plain, sub-blocks taken in the kernels' order;
    with ``want_levels`` also each step's winner's zigzag levels (B, N,
    16, 16), from the context the step sees."""
    B, N = src.shape[:2]
    scr = torch.zeros((B, N, 17, 21), dtype=I32)
    scr[:, :, 0, 0] = tl
    scr[:, :, 0, 1:17] = top16
    scr[:, :, 0, 17:21] = tr4
    scr[:, :, 1:17, 0] = left16
    quants5 = torch.stack([iqlane[..., 0], iqlane[..., 1], qlane[..., 0],
                           qlane[..., 1], pen], dim=-1).reshape(B * N, 5)
    bmodes = torch.full((B, N, 16), -1, dtype=I32)
    s4 = torch.zeros((B, N), dtype=I32)
    levels = torch.zeros((B, N, 16, 16), dtype=I32)
    for step in kernel_diagonals():
        for gy, gx in step:
            r, c = 4 * gy, 4 * gx
            tr = scr[:, :, 0, 17:21] if gx == 3 else scr[:, :, r, c + 5:c + 9]
            ctx13 = torch.cat([scr[:, :, r, c:c + 5], tr,
                               scr[:, :, r + 1:r + 5, c]], dim=-1)
            bmode, bcost, brec = i4_search_plain(
                ctx13.reshape(B * N, 13),
                src[:, :, r:r + 4, c:c + 4].reshape(B * N, 16), quants5, t3)
            if want_levels:
                preds = _pred_luma4_all(ctx13[..., 0], ctx13[..., 1:5],
                                        ctx13[..., 5:9], ctx13[..., 9:13])
                pred = torch.gather(preds, 2, bmode.reshape(B, N, 1, 1, 1)
                                    .long().expand(B, N, 1, 4, 4))[:, :, 0]
                levels[:, :, 4 * gy + gx] = quantize(
                    fdct4x4(src[:, :, r:r + 4, c:c + 4] - pred),
                    iqlane[..., 0], BIAS["y1_dc"], iqlane[..., 1],
                    BIAS["y1_ac"])
            scr[:, :, r + 1:r + 5, c + 1:c + 5] = brec.reshape(B, N, 4, 4)
            bmodes[:, :, 4 * gy + gx] = bmode.reshape(B, N)
            s4 += bcost.reshape(B, N)
    out = (bmodes, s4, scr[:, :, 1:17, 1:17].to(torch.uint8))
    return out + (levels,) if want_levels else out


@pytest.mark.parametrize("quality,seed", [(75.0, 1), (75.0, 2), (99.0, 3)])
def test_diagonal_walk_equals_raster_walk(quality, seed):
    args = _walk_case(seed, quality)
    t3 = t3_tables(tuple(torch.from_numpy(t.astype(np.int32))
                         for t in _default_cost_tables()))
    want = i4_walk_plain(*args, t3, want_recon=True)
    got = _diagonal_walk(*args, t3)
    for name, a, b in zip(("bmodes", "s4", "recon"), got, want):
        assert torch.equal(a, b), name
    assert len(torch.unique(want[0])) > 3          # several modes won


def _fixed_i4_case(seed, quality, B=2, H=48, W=64):
    rng = np.random.default_rng(seed)
    mh, mw = H // 16, W // 16
    y = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    u = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8)
    q = make_quants(quality_to_q(quality))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q,
                    q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    qs[:, 1] = np.clip(qs[:, 1] * 2, 1, 255)
    qs[:, 3] = np.clip(qs[:, 3] + 9, 1, 255)
    seg = rng.integers(0, 4, (B, mh, mw)).astype(np.int32)
    modes = (rng.integers(0, 4, (B, mh, mw)).astype(np.int32),
             rng.integers(0, 4, (B, mh, mw)).astype(np.int32),
             np.ones((B, mh, mw), np.int32),
             rng.integers(0, 10, (B, mh, mw, 16)).astype(np.int32))
    t = torch.from_numpy
    return (t(y), t(u), t(v), t(seg), t(qs)) + tuple(t(m) for m in modes)


@pytest.mark.parametrize("quality,seed", [(75.0, 4), (30.0, 5)])
def test_fixed_i4_chain_in_diagonal_order(quality, seed):
    """Each MB's chain redone in the kernel's diagonal order, from the
    context the plain wavefront's recon gives it, yields its levels and
    recon."""
    args = _fixed_i4_case(seed, quality)
    y, seg, qs, imodes = args[0], args[3], args[4], args[8]
    out = wavefront_fixed_plain(*args, use_derr=True, want_recon=True)
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    N = mh * mw
    recon = out["recon_y"].to(I32)
    top16, tr4, left16, tl, _, _ = mb_context(recon, mh, mw, 16)
    src = y.to(I32).reshape(B, mh, 16, mw, 16).permute(0, 1, 3, 2, 4)
    src = src.reshape(B, N, 16, 16)
    rows = qs[torch.arange(B)[:, None], seg.reshape(B, N).long()]  # (B,N,6)
    iq = (1 << 17) // rows
    scr = torch.zeros((B, N, 17, 21), dtype=I32)
    scr[:, :, 0, 0] = tl
    scr[:, :, 0, 1:17] = top16
    scr[:, :, 0, 17:21] = tr4
    scr[:, :, 1:17, 0] = left16
    levels = torch.zeros((B, N, 16, 16), dtype=I32)
    im = imodes.reshape(B, N, 16).long()
    for step in kernel_diagonals():
        for gy, gx in step:
            n, r, c = 4 * gy + gx, 4 * gy, 4 * gx
            tr = scr[:, :, 0, 17:21] if gx == 3 else scr[:, :, r, c + 5:c + 9]
            preds = _pred_luma4_all(scr[:, :, r, c], scr[:, :, r, c + 1:c + 5],
                                    tr, scr[:, :, r + 1:r + 5, c])
            pred = torch.gather(preds, 2, im[:, :, n, None, None, None]
                                .expand(B, N, 1, 4, 4))[:, :, 0]
            cf = fdct4x4(src[:, :, r:r + 4, c:c + 4] - pred)
            lv = quantize(cf, iq[..., 0], BIAS["y1_dc"], iq[..., 1],
                          BIAS["y1_ac"])
            levels[:, :, n] = lv
            scr[:, :, r + 1:r + 5, c + 1:c + 5] = idct_add_clip(
                dequantize(lv, rows[..., 0], rows[..., 1]), pred)
    assert torch.equal(levels.to(torch.int16),
                       out["y_levels"].reshape(B, N, 16, 16))
    got = scr[:, :, 1:17, 1:17].reshape(B, mh, mw, 16, 16)
    assert torch.equal(got.permute(0, 1, 3, 2, 4).reshape(B, H, W),
                       recon)


def _plain_reads(my, mx, mw):
    """MBs of earlier rows and of its own row whose recon or carries
    wavefront_fixed_plain reads for MB (my, mx): top, top-left, top-right
    (the last column's repeats its top), dtop, left."""
    reads = []
    if my > 0:
        reads += [(my - 1, mx), (my - 1, min(mx + 1, mw - 1))]   # top, tr
        if mx > 0:
            reads.append((my - 1, mx - 1))                        # top-left
    if mx > 0:
        reads.append((my, mx - 1))                                # left
    return reads


def _row_wait(mx, mw):
    """MBs of the row above that the kernel waits for before MB mx."""
    return min(mx + 2, mw)


def test_row_wait_rule_is_the_kernels():
    text = (KERNEL_DIR / "wavefront_fixed.cu").read_text()
    assert re.search(r"need = min\(mx \+ 2, mw\)", text)
    assert re.search(r"my = t / a\.B, b = t - my \* a\.B", text)
    assert re.search(r"row = b \* mh \+ my", text)
    assert re.search(r"ld_acquire\(a\.progress \+ row - 1\)", text)
    assert re.search(r"st_release\(a\.progress \+ row, mx \+ 1\)", text)


@pytest.mark.parametrize("mh", [1, 2, 3, 5, 64])
@pytest.mark.parametrize("mw", [1, 2, 3, 5, 64])
def test_row_wait_schedule_is_valid(mw, mh):
    # every read of MB (my, mx) is published before it starts
    for my in range(mh):
        for mx in range(mw):
            for ry, rx in _plain_reads(my, mx, mw):
                if ry == my - 1:
                    assert rx < _row_wait(mx, mw)
                else:
                    assert ry == my and rx < mx
    # persistent blocks claiming rows by ticket finish, whatever their count
    B = 2
    rows = B * mh

    def row_of(t):                      # ticket t = my * B + b
        return (t % B) * mh + t // B

    for resident in (1, 2, 3, rows + 1):
        progress = [0] * rows
        owner = {}                      # block -> row it works on
        ticket = 0
        for blk in range(min(resident, rows)):
            owner[blk] = row_of(ticket)
            ticket += 1
        while owner:
            moved = False
            for blk, row in list(owner.items()):
                my, mx = row % mh, progress[row]
                if my > 0 and progress[row - 1] < _row_wait(mx, mw):
                    continue            # waits on an earlier ticket's row
                for ry, rx in _plain_reads(my, mx, mw):
                    assert progress[row - my + ry] > rx
                progress[row] += 1
                moved = True
                if progress[row] == mw:
                    if ticket < rows:
                        owner[blk] = row_of(ticket)
                        ticket += 1
                    else:
                        del owner[blk]
            assert moved, "deadlock"
        assert progress == [mw] * rows


def test_row_wait_rule_is_the_search_kernels():
    """wavefront_search.cu keeps the fixed kernel's schedule."""
    text = (KERNEL_DIR / "wavefront_search.cu").read_text()
    assert re.search(r"need = min\(mx \+ 2, mw\)", text)
    assert re.search(r"my = t / a\.B, b = t - my \* a\.B", text)
    assert re.search(r"row = b \* mh \+ my", text)
    assert re.search(r"ld_acquire\(a\.progress \+ row - 1\)", text)
    assert re.search(r"st_release\(a\.progress \+ row, mx \+ 1\)", text)


@pytest.mark.parametrize("quality,seed", [(75.0, 6), (99.0, 7), (30.0, 8)])
def test_full_search_step_in_kernel_order(quality, seed):
    """wavefront_search's MB step, in the kernel's order, from the context
    the plain full search's recon gives each MB: the i4 walk in diagonal
    order finds the plain search's B-modes and recon for every i4 MB, and
    the levels each step's winner writes, from the context that step
    sees (the kernel's order: no pass after the walk), are the plain
    chain's."""
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search_plain)

    tables = tuple(torch.from_numpy(t.astype(np.int32))
                   for t in _default_cost_tables())
    args = _fixed_i4_case(seed, quality)
    y, u, v, seg, qs = args[:5]
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    N = mh * mw
    y = y.clone()
    y[:, :16] = 128                             # i16 MBs in the top row
    rows = qs[torch.arange(B)[:, None], seg.reshape(B, N).long()]  # (B,N,6)
    pen = (rows[..., 1] ** 2 * 2).to(I32)       # per-MB lambdas < 2**19
    pens = torch.stack([(qs[:, s, 1] ** 2 * 2).to(I32) for s in range(4)], 1)
    out = wavefront_search_plain(y, u, v, seg, qs, pens,
                                 search_tables(tables), try_i4=True,
                                 use_derr=True, want_recon=True)
    is4 = out["is_i4"].reshape(B, N).bool()
    assert is4.any() and not is4.all()
    recon = out["recon_y"].to(I32)
    top16, tr4, left16, tl, _, _ = mb_context(recon, mh, mw, 16)
    src = y.to(I32).reshape(B, mh, 16, mw, 16).permute(0, 1, 3, 2, 4)
    src = src.reshape(B, N, 16, 16)
    iq = (1 << 17) // rows
    bmodes, _, rec, levels = _diagonal_walk(src, top16, tr4, left16, tl, rows,
                                            iq, pen, t3_tables(tables),
                                            want_levels=True)
    final = recon.reshape(B, mh, 16, mw, 16).permute(0, 1, 3, 2, 4).reshape(
        B, N, 16, 16)
    imodes = out["imodes"].reshape(B, N, 16).to(I32)
    assert torch.equal(bmodes[is4], imodes[is4])
    assert torch.equal(rec[is4].to(I32), final[is4])
    got = out["y_levels"].reshape(B, N, 16, 16).to(I32)
    assert torch.equal(levels[is4], got[is4])
    assert (out["y2_levels"].reshape(B, N, 16)[is4] == 0).all()
