"""PyTorch port: the decode's recon and loop-filter kernels, their CPU side.

- ``recon_frame`` sends CPU tensors to the plain torch loops and counts no
  kernel launch; the bindings' shape checks raise on bad inputs.
- The plain loops (the kernels' reference on the card) still equal the
  JAX package's ``vp8_recon_jax.recon_frame`` at B=2 on odd MB grids, for
  every filter type.
- The orders the kernels run in: MB by MB along rows, a row's MB mx once
  the row above has published min(mx + 2, mw) MBs (any such interleaving),
  the i4 sub-blocks of an MB on the slope-2 diagonals d = 2*gy + gx with
  the MB's top-right pixels repeated down column 17-20 of the scratch, and
  the filter's per-MB 20x20 / 12x12 windows written back less their
  corner: each gives the plain wavefront's planes.
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
    before = (kvr.recon_mb.launches, kvr.loop_filter_mb.launches)
    marks = []
    got = precon.recon_frame(*_frame_args(coeffs, modes, fp), mb_w=5, mb_h=3,
                             filter_type=2, marks=marks.append)
    assert marks == ["idct", "recon", "filter"]
    assert (kvr.recon_mb.launches, kvr.loop_filter_mb.launches) == before
    planes = kvr.recon_mb(coeffs, modes, 5, 3)
    want = kvr.loop_filter_mb(*planes, fp, 5, 3, 2)
    assert (kvr.recon_mb.launches, kvr.loop_filter_mb.launches) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["coeffs_shape", "modes_bytes", "grid",
                                 "zero_grid", "device"])
def test_recon_binding_rejects_bad_inputs(bad):
    coeffs, modes, _ = _case(2, 1, 2, 2)
    args = {"coeffs_shape": (coeffs[:, :3], modes, 2, 2),
            "modes_bytes": (coeffs, modes[..., :16], 2, 2),
            "grid": (coeffs, modes, 3, 1),
            "zero_grid": (coeffs, modes, 0, 4),
            "device": (coeffs.to("meta"), modes.to("meta"), 2, 2)}[bad]
    with pytest.raises(ValueError):
        kvr.recon_mb(*args)


@pytest.mark.parametrize("bad", ["filter_type", "y_shape", "u_shape",
                                 "fparams", "device"])
def test_filter_binding_rejects_bad_inputs(bad):
    coeffs, modes, fp = _case(3, 1, 2, 2)
    y, u, v = kvr.recon_mb(coeffs, modes, 2, 2)
    args = {"filter_type": (y, u, v, fp, 2, 2, 3),
            "y_shape": (y[:, :16], u, v, fp, 2, 2, 2),
            "u_shape": (y, u[:, :, :8], v, fp, 2, 2, 2),
            "fparams": (y, u, v, fp[:, :1], 2, 2, 2),
            "device": (y.to("meta"), u.to("meta"), v.to("meta"),
                       fp.to("meta"), 2, 2, 2)}[bad]
    with pytest.raises(ValueError):
        kvr.loop_filter_mb(*args)


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
# The kernels' orders
# ---------------------------------------------------------------------------

def _schedule(B, mb_h, mb_w, seed):
    """A random interleaving of the MBs that the kernels' wait rule allows:
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


def _recon_model(coeffs, modes, mb_w, mb_h, order):
    """recon_mb's steps, MB by MB in ``order``: the context read from the
    planes written so far (127 above the frame, 129 left of it and at the
    corner below row 0; the last column's top-right repeats its top's
    end), i4 sub-blocks on the diagonals d = 2*gy + gx."""
    B = coeffs.shape[0]
    Yres, Ures, Vres = precon.residual_blocks(coeffs.to(I32))
    m = modes.to(I32)
    Y = torch.zeros((B, 16 * mb_h, 16 * mb_w), dtype=I32)
    C = torch.zeros((2, B, 8 * mb_h, 8 * mb_w), dtype=I32)
    for b, my, mx in order:
        n = my * mb_w + mx
        ht, hl = torch.tensor(my > 0), torch.tensor(mx > 0)
        y0, x0 = 16 * my, 16 * mx
        scr = torch.zeros((17, 21), dtype=I32)
        if my > 0:
            row = Y[b, y0 - 1]
            scr[0, 1:17] = row[x0:x0 + 16]
            scr[0, 17:21] = (row[x0 + 15] if mx == mb_w - 1
                             else row[x0 + 16:x0 + 20])
            scr[0, 0] = row[x0 - 1] if mx > 0 else 129
        else:
            scr[0] = 127
        scr[1:, 0] = Y[b, y0:y0 + 16, x0 - 1] if mx > 0 else 129
        for r in (4, 8, 12):
            scr[r, 17:21] = scr[0, 17:21]
        if m[b, n, 0]:
            steps = [(gy, d - 2 * gy) for d in range(10) for gy in range(4)
                     if 0 <= d - 2 * gy <= 3]
            for gy, gx in steps:
                r, c = 4 * gy, 4 * gx
                p10 = precon._pred_luma4_all(
                    scr[r, c], scr[r, c + 1:c + 5], scr[r, c + 5:c + 9],
                    scr[r + 1:r + 5, c])
                mode = int(m[b, n, 2 + 4 * gy + gx])
                scr[r + 1:r + 5, c + 1:c + 5] = torch.clamp(
                    p10[mode] + Yres[b, n, r:r + 4, c:c + 4], 0, 255)
        else:
            pred = precon.predict4_blocks(scr[0, 1:17], scr[1:, 0], scr[0, 0],
                                          ht, hl, 16)
            scr[1:, 1:17] = torch.clamp(
                pred[min(int(m[b, n, 2]), 3)] + Yres[b, n], 0, 255)
        Y[b, y0:y0 + 16, x0:x0 + 16] = scr[1:, 1:17]
        for ch, res in ((0, Ures), (1, Vres)):
            P = C[ch, b]
            cy, cx = 8 * my, 8 * mx
            top = P[cy - 1, cx:cx + 8] if my > 0 else torch.full((8,), 127)
            left = P[cy:cy + 8, cx - 1] if mx > 0 else torch.full((8,), 129)
            tl = (P[cy - 1, cx - 1] if my > 0 and mx > 0
                  else torch.tensor(129 if my > 0 else 127))
            pred = precon.predict4_blocks(top, left, tl, ht, hl, 8)
            P[cy:cy + 8, cx:cx + 8] = torch.clamp(
                pred[int(m[b, n, 1])] + res[b, n], 0, 255)
    return Y.to(torch.uint8), C[0].to(torch.uint8), C[1].to(torch.uint8)


@pytest.mark.parametrize("B,mb_h,mb_w", [(2, 3, 5), (1, 1, 4), (1, 4, 1),
                                         (3, 2, 3)])
def test_recon_kernel_order_gives_the_wavefront_planes(B, mb_h, mb_w):
    coeffs, modes, _ = _case(B * 7 + mb_h * 3 + mb_w, B, mb_h, mb_w)
    want = kvr.recon_mb_plain(coeffs, modes, mb_w, mb_h)
    for seed in range(2):
        got = _recon_model(coeffs, modes, mb_w, mb_h,
                           _schedule(B, mb_h, mb_w, seed))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _filter_model(y, u, v, fparams, mb_w, mb_h, filter_type, order):
    """loop_filter_mb's steps, MB by MB in ``order``: the MB's windows (4
    pixels up and left) read from the planes, its edges filtered in
    libwebp's order on one strip a pixel line, and the window written back
    less its top row, left column and the corner above-left of the MB."""
    simple = filter_type == 1
    K = 2 if simple else 4
    planes = [p.to(I32).clone() for p in (y, u, v)]
    fp = fparams.to(I32).reshape(y.shape[0], mb_h * mb_w, 4)
    for b, my, mx in order:
        limit, il, hev, inner = (int(t) for t in fp[b, my * mb_w + mx])
        if limit < 0:
            continue
        pm = [torch.tensor([[2 * (limit + 4) + 1]]), torch.tensor([[il]]),
              torch.tensor([[hev]])]
        pe = [torch.tensor([[2 * limit + 1]])] + pm[1:]
        for p, s in zip(planes if not simple else planes[:1], (16, 8, 8)):
            r0, c0 = s * my - 4, s * mx - 4
            w = torch.zeros((s + 4, s + 4), dtype=I32)
            rs, cs = max(r0, 0), max(c0, 0)
            w[rs - r0:, cs - c0:] = p[b, rs:r0 + s + 4, cs:c0 + s + 4]
            inner_at = range(8, s + 1, 4)

            def edge(at, vertical, params, mb_edge):
                strip = (w[4:, at - K:at + K] if vertical
                         else w[at - K:at + K, 4:].T)[None, None]
                out = (precon._lanes_simple(strip, params[0]) if simple
                       else precon._lanes_complex(strip, *params, mb_edge))
                if vertical:
                    w[4:, at - K:at + K] = out[0, 0]
                else:
                    w[at - K:at + K, 4:] = out[0, 0].T

            if mx > 0:
                edge(4, True, pm, True)
            for at in inner_at if inner else ():
                edge(at, True, pe, False)
            if my > 0:
                edge(4, False, pm, True)
            for at in inner_at if inner else ():
                edge(at, False, pe, False)
            keep = w.clone()
            keep[:, :1] = -1
            keep[:1] = -1
            keep[:4, :4] = -1
            win = p[b, rs:r0 + s + 4, cs:c0 + s + 4]
            part = keep[rs - r0:, cs - c0:]
            win[part >= 0] = part[part >= 0]
    return tuple(p.to(torch.uint8) for p in planes)


@pytest.mark.parametrize("filter_type", [1, 2])
@pytest.mark.parametrize("B,mb_h,mb_w", [(2, 3, 5), (1, 1, 4), (1, 4, 1),
                                         (2, 4, 3)])
def test_filter_kernel_order_gives_the_wavefront_planes(filter_type, B, mb_h,
                                                        mb_w):
    coeffs, modes, fp = _case(B * 5 + mb_h * 11 + mb_w, B, mb_h, mb_w)
    planes = kvr.recon_mb_plain(coeffs, modes, mb_w, mb_h)
    want = kvr.loop_filter_mb_plain(*(p.clone() for p in planes), fp, mb_w,
                                    mb_h, filter_type)
    for seed in range(2):
        got = _filter_model(*planes, fp, mb_w, mb_h, filter_type,
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
