"""PyTorch port: the decode's fused recon and loop-filter kernel, its CPU
side.

- ``recon_frame`` sends CPU tensors to the plain torch loops and counts no
  kernel launch; the binding's checks raise on bad inputs.
- The plain loops (the kernel's reference on the card) still equal the
  JAX package's ``vp8_recon_jax.recon_frame`` at B=2 on odd MB grids, for
  every filter type.
- The order and data flow the kernel runs in: MB by MB along rows, a
  row's MB mx once the row above has published min(mx + 2, mw) MBs (any
  such interleaving), each MB reconstructed from the unfiltered
  top-samples row of the row above and its own row's left column (the i4
  sub-blocks on the slope-2 diagonals d = 2*gy + gx, the MB's top-right
  pixels repeated down column 17-20 of the scratch), then filtered at once
  in a window of the 4 filtered rows above (read from the planes), the 4
  filtered columns of the MB to its left (kept from the last step) and the
  MB, and written back as the kernel writes: the MB, and what its edges
  changed left and above.  It gives the plain recon followed by the plain
  filter.
- ``yuv420_to_rgba``'s ``fancy=False`` form against the JAX package's
  nearest upsampling.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gowebp_tpu.models.vp8.decoder import yuv_planes_to_rgba as jyuv_to_rgba
from gowebp_tpu.ops import vp8_recon_jax as jrecon
from gowebp_tpu.ops import yuv_np
from gowebp_tpu_torch.ops import vp8_recon as precon
from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import yuv420_to_rgba_plain
from gowebp_tpu_torch.ops.yuv import simple_upsample

I32 = torch.int32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed, B, mb_h, mb_w):
    """chip_smoke.py's random recon inputs, on the CPU: i4/i16 mixes (an
    i4 MB's first B-mode may exceed 3), skip MBs, four segments with
    distinct filter levels (one off), inner edges on and off."""
    return _chip_smoke().random_symbols("cpu", seed, B, mb_h, mb_w)


def _frame_args(coeffs, modes, fparams):
    m = modes.to(I32)
    return coeffs, m[..., 0], m[..., 2:], m[..., 1], fparams


def test_recon_frame_on_cpu_runs_the_plain_loops_and_counts_no_launch():
    coeffs, modes, fp = _case(1, 2, 3, 5)
    before = kvr.recon_filter_mb.launches
    marks = []
    got = precon.recon_frame(*_frame_args(coeffs, modes, fp), mb_w=5, mb_h=3,
                             filter_type=2, marks=marks.append)
    assert marks == ["idct", "recon", "filter"]
    assert kvr.recon_filter_mb.launches == before
    want = kvr.recon_filter_mb(coeffs, modes, fp, 5, 3, 2)
    assert kvr.recon_filter_mb.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        assert torch.equal(g, w)


BAD_INPUTS = ["coeffs_shape", "coeffs_rank", "modes_bytes", "modes_batch",
              "grid", "zero_grid", "filter_type", "fparams", "fparams_width",
              "device"]


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_binding_rejects_bad_inputs(bad):
    coeffs, modes, fp = _case(2, 1, 2, 2)
    args = {"coeffs_shape": (coeffs[:, :3], modes, fp, 2, 2, 2),
            "coeffs_rank": (coeffs.reshape(1, 4, 384), modes, fp, 2, 2, 2),
            "modes_bytes": (coeffs, modes[..., :16], fp, 2, 2, 2),
            "modes_batch": (coeffs, modes.repeat(2, 1, 1), fp, 2, 2, 2),
            "grid": (coeffs, modes, fp, 3, 1, 2),
            "zero_grid": (coeffs, modes, fp, 0, 4, 2),
            "filter_type": (coeffs, modes, fp, 2, 2, 3),
            "fparams": (coeffs, modes, fp[:, :1], 2, 2, 2),
            "fparams_width": (coeffs, modes, fp.reshape(1, 2, 2, 2, 2), 2, 2,
                              2),
            "device": (coeffs.to("meta"), modes.to("meta"), fp.to("meta"), 2,
                       2, 2)}[bad]
    with pytest.raises(ValueError):
        kvr.recon_filter_mb(*args)


@pytest.mark.parametrize("filter_type", [0, 1, 2])
@pytest.mark.parametrize("mb_h,mb_w", [(1, 5), (5, 1), (3, 5)])
def test_plain_loops_match_jax_recon_frame(mb_h, mb_w, filter_type):
    coeffs, modes, fp = _case(mb_h * 10 + mb_w + filter_type, 2, mb_h, mb_w)
    args = _frame_args(coeffs, modes, fp)
    kw = dict(mb_w=mb_w, mb_h=mb_h, filter_type=filter_type)
    want = jrecon.recon_frame(*(a.numpy() for a in args), **kw)
    planes = kvr.recon_mb_plain(coeffs, modes, mb_w, mb_h)
    got = kvr.loop_filter_mb_plain(*planes, fp, mb_w, mb_h, filter_type)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The kernel's order and buffers
# ---------------------------------------------------------------------------

def _schedule(B, mb_h, mb_w, seed):
    """A random interleaving of the MBs that the kernel's wait rule allows:
    each row walks left to right, MB mx of row my once row my-1 has done
    min(mx + 2, mw) MBs."""
    rng = np.random.default_rng(seed)
    done = np.zeros((B, mb_h), np.int64)
    order = []
    while len(order) < B * mb_h * mb_w:
        ready = [(b, y) for b in range(B) for y in range(mb_h)
                 if done[b, y] < mb_w and (
                     y == 0 or done[b, y - 1] >= min(done[b, y] + 2, mb_w))]
        b, y = ready[rng.integers(len(ready))]
        order.append((b, y, int(done[b, y])))
        done[b, y] += 1
    return order


def _edge(w, at, vertical, params, mb_edge, simple):
    """One edge of a filter window, in place: the column ``at`` across the
    window's rows 4.. (vertical) or the row ``at`` across its columns 4..,
    as ops/vp8_recon.py's strips."""
    K = 2 if simple else 4
    strip = (w[4:, at - K:at + K] if vertical
             else w[at - K:at + K, 4:].T)[None, None]
    out = (precon._lanes_simple(strip, params[0]) if simple
           else precon._lanes_complex(strip, *params, mb_edge))
    if vertical:
        w[4:, at - K:at + K] = out[0, 0]
    else:
        w[at - K:at + K, 4:] = out[0, 0].T


def _read(t):
    """A read the kernel makes of what another step wrote: it must have
    been written (every buffer starts at -1)."""
    assert (t >= 0).all(), "read before it was written"
    return t


def _predict4_chroma(sc, ht, hl):
    """The four whole-block predictions of a chroma MB from its (9, 9)
    scratch: row 0 [corner, top 8], column 0 the left 8."""
    return precon.predict4_blocks(sc[0, 1:], sc[1:, 0], sc[0, 0], ht, hl, 8)


def _fused_model(coeffs, modes, fparams, mb_w, mb_h, filter_type, order):
    """recon_filter_mb's steps, MB by MB in ``order``, with its buffers:
    the planes, the top-samples rows (each MB row's unfiltered bottom
    row) and, per MB row, the recon scratch and the filter windows, whose
    left column and left 4 columns carry from one MB to the next."""
    B = coeffs.shape[0]
    simple = filter_type == 1
    Yres, Ures, Vres = precon.residual_blocks(coeffs.to(I32))
    m = modes.to(I32)
    fp = fparams.to(I32).reshape(B, mb_h * mb_w, 4)
    planes = [torch.full((B, s * mb_h, s * mb_w), -1, dtype=I32)
              for s in (16, 8, 8)]
    tops = [torch.full((B, mb_h, s * mb_w), -1, dtype=I32)
            for s in (16, 8, 8)]
    # per row: the (17, 21) / (9, 9) recon scratch and the 20x20 / 12x12
    # filter window of each plane
    scr = {}
    win = {}
    for b, my, mx in order:
        n = my * mb_w + mx
        ht, hl = my > 0, mx > 0
        if mx == 0:
            scr[b, my] = [torch.zeros((s + 1, s + (5 if s == 16 else 1)),
                                      dtype=I32) for s in (16, 8, 8)]
            win[b, my] = [torch.zeros((s + 4, s + 4), dtype=I32)
                          for s in (16, 8, 8)]
        S, Wn = scr[b, my], win[b, my]
        # ---- recon: context from the top samples and the row's scratch ----
        for p, s in enumerate((16, 8, 8)):
            sc, x0 = S[p], s * mx
            corner = sc[0, s].clone()             # the last MB's top end
            left = sc[1:, s].clone()              # the last MB's last column
            if ht:
                row = tops[p][b, my - 1]
                sc[0, 1:s + 1] = _read(row[x0:x0 + s])
                if p == 0:
                    sc[0, 17:21] = _read(row[x0 + 15] if mx == mb_w - 1
                                         else row[x0 + 16:x0 + 20])
            else:
                sc[0, 1:] = 127
            sc[0, 0] = corner if hl else (129 if ht else 127)
            sc[1:, 0] = left if hl else 129
        sy = S[0]
        for r in (4, 8, 12):
            sy[r, 17:21] = sy[0, 17:21]
        tht, thl = torch.tensor(ht), torch.tensor(hl)
        if m[b, n, 0]:
            steps = [(gy, d - 2 * gy) for d in range(10) for gy in range(4)
                     if 0 <= d - 2 * gy <= 3]
            for gy, gx in steps:
                r, c = 4 * gy, 4 * gx
                p10 = precon._pred_luma4_all(
                    sy[r, c], sy[r, c + 1:c + 5], sy[r, c + 5:c + 9],
                    sy[r + 1:r + 5, c])
                mode = int(m[b, n, 2 + 4 * gy + gx])
                sy[r + 1:r + 5, c + 1:c + 5] = torch.clamp(
                    p10[mode] + Yres[b, n, r:r + 4, c:c + 4], 0, 255)
        else:
            pred = precon.predict4_blocks(sy[0, 1:17], sy[1:, 0], sy[0, 0],
                                          tht, thl, 16)
            sy[1:, 1:17] = torch.clamp(
                pred[min(int(m[b, n, 2]), 3)] + Yres[b, n], 0, 255)
        for sc, res in ((S[1], Ures), (S[2], Vres)):
            pred = _predict4_chroma(sc, tht, thl)
            sc[1:, 1:] = torch.clamp(pred[int(m[b, n, 1])] + res[b, n], 0,
                                     255)
        for p, s in enumerate((16, 8, 8)):
            if my < mb_h - 1:
                tops[p][b, my, s * mx:s * mx + s] = S[p][s, 1:s + 1]
        # ---- filter the MB at once, in its windows ----
        limit, il, hev, inner = (int(t) for t in fp[b, n])
        for p, s in enumerate((16, 8, 8)):
            w, P = Wn[p], planes[p][b]
            r0, c0 = s * my, s * mx
            on = filter_type and limit >= 0 and (p == 0 or not simple)
            w[4:, 4:] = S[p][1:, 1:s + 1]
            if on:
                if ht:
                    w[:4, 4:] = _read(P[r0 - 4:r0, c0:c0 + s])
                pm = [torch.tensor([[2 * (limit + 4) + 1]]),
                      torch.tensor([[il]]), torch.tensor([[hev]])]
                pe = [torch.tensor([[2 * limit + 1]])] + pm[1:]
                for vertical, has in ((True, hl), (False, ht)):
                    if has:
                        _edge(w, 4, vertical, pm, True, simple)
                    for at in range(8, s + 1, 4) if inner else ():
                        _edge(w, at, vertical, pe, False, simple)
            P[r0:r0 + s, c0:c0 + s] = w[4:, 4:]
            if on and hl:
                P[r0:r0 + s, c0 - 4:c0] = w[4:, :4]
            if on and ht:
                P[r0 - 3:r0, c0:c0 + s] = w[1:4, 4:]
            w[4:, :4] = w[4:, s:s + 4].clone()    # the next MB's left columns
    return tuple(p.to(torch.uint8) for p in planes)


@pytest.mark.parametrize("filter_type", [0, 1, 2])
@pytest.mark.parametrize("B,mb_h,mb_w", [(2, 3, 5), (1, 1, 4), (1, 4, 1),
                                         (2, 4, 3)])
def test_fused_kernel_order_gives_recon_then_filter(filter_type, B, mb_h,
                                                     mb_w):
    coeffs, modes, fp = _case(B * 5 + mb_h * 11 + mb_w, B, mb_h, mb_w)
    want = kvr.loop_filter_mb_plain(*kvr.recon_mb_plain(coeffs, modes, mb_w,
                                                        mb_h),
                                    fp, mb_w, mb_h, filter_type)
    for seed in range(2):
        got = _fused_model(coeffs, modes, fp, mb_w, mb_h, filter_type,
                           _schedule(B, mb_h, mb_w, seed))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("h,w", [(1, 1), (17, 2), (33, 17), (64, 48)])
def test_nearest_upsampling_matches_jax(h, w):
    rng = np.random.default_rng(h * 100 + w)
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (h2, w2), dtype=np.uint8) for _ in range(2))
    np.testing.assert_array_equal(
        simple_upsample(torch.from_numpy(u), h, w).numpy(),
        yuv_np.simple_upsample(u, h, w))
    want = jyuv_to_rgba(y, u, v, fancy_upsampling=False)
    got = yuv420_to_rgba_plain(*(torch.from_numpy(p)[None] for p in (y, u, v)),
                               h, w, fancy=False)
    np.testing.assert_array_equal(got[0].numpy(), want)
