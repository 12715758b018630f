"""The VP8L predictor inverse and add-green inverse against the JAX package.

``predictor_inverse`` (ops/kernels/vp8l_inverse.py's plain version on the
CPU) and ``add_green_inverse`` must equal gowebp_tpu/ops/lossless_jax.py's
bit for bit: every one of the 14 predictors (a whole mode image of one
mode, and mixed maps), tile bits 2-5, widths 1, 2 and odd, heights 1 and
odd, modes past 13.  A numpy model of the kernel's schedule (one thread a
row, the skewed wavefront t = x + 2y, the 4-slot ring of each row's last
pixels, bands of rows that read the band above from the output with the
add-green epilogue undone) must give the plain version's pixels, with
every ring read landing on the pixel it needs.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gowebp_tpu.ops.lossless_jax import add_green_inverse as jax_add_green
from gowebp_tpu.ops.lossless_jax import predictor_inverse as jax_inverse
from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
from gowebp_tpu_torch.ops.kernels.vp8l_inverse import predictor_inverse_plain
from gowebp_tpu_torch.ops.lossless import (add_green_inverse,
                                           predictor_inverse)


def _case(seed, h, w, bits, mode=None, top=14):
    rng = np.random.default_rng(seed)
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    res = rng.integers(0, 1 << 32, (2, h, w), dtype=np.uint32)
    modes = (rng.integers(0, top, (th, tw), dtype=np.uint32)
             if mode is None else np.full((th, tw), mode, np.uint32))
    # the other bytes of a mode word are ignored
    mode_img = (rng.integers(0, 1 << 32, (th, tw), dtype=np.uint32)
                & np.uint32(0xFFFF00FF)) | (modes << 8)
    return res, mode_img


def _port(res, mode_img, bits, add_green=False):
    out = predictor_inverse(torch.from_numpy(res.view(np.int32)),
                            torch.from_numpy(mode_img.view(np.int32)), bits,
                            add_green=add_green)
    return out.numpy().view(np.uint32)


def _jax(res, mode_img, bits, add_green=False):
    out = [jax_inverse(jnp.asarray(r), jnp.asarray(mode_img), bits)
           for r in res]
    if add_green:
        out = [jax_add_green(o) for o in out]
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("mode", range(14))
def test_each_predictor_matches_jax(mode):
    res, mode_img = _case(mode, 11, 13, 2, mode=mode)
    np.testing.assert_array_equal(_port(res, mode_img, 2),
                                  _jax(res, mode_img, 2))


@pytest.mark.parametrize("bits", [2, 3, 4, 5])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (7, 1), (5, 2), (9, 17),
                                 (33, 7)])
def test_mixed_modes_match_jax(h, w, bits):
    res, mode_img = _case(h * 100 + w + bits, h, w, bits)
    np.testing.assert_array_equal(_port(res, mode_img, bits),
                                  _jax(res, mode_img, bits))


@pytest.mark.parametrize("h,w", [(1, 5), (6, 3), (19, 21)])
def test_add_green_epilogue_matches_jax(h, w):
    res, mode_img = _case(h + w, h, w, 3)
    np.testing.assert_array_equal(_port(res, mode_img, 3, add_green=True),
                                  _jax(res, mode_img, 3, add_green=True))


def test_modes_past_13_predict_zero_as_jax():
    """The reference's select has no case past mode 13: it predicts 0."""
    res, mode_img = _case(5, 9, 10, 2, top=16)
    assert ((mode_img >> 8) & 255).max() >= 14
    np.testing.assert_array_equal(_port(res, mode_img, 2),
                                  _jax(res, mode_img, 2))


@pytest.mark.parametrize("shape", [(1,), (3, 7), (2, 5, 4)])
def test_add_green_inverse_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    argb = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    got = add_green_inverse(torch.from_numpy(argb.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jax_add_green(jnp.asarray(argb))))


def test_predictor_inverse_checks_its_mode_image():
    res = torch.zeros((1, 9, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode_img"):
        predictor_inverse(res, torch.zeros((2, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match=r"\(B, h, w\)"):
        predictor_inverse(res[0], torch.zeros((3, 3), dtype=torch.int32), 2)


# ---------------------------------------------------------------------------
# A numpy model of vp8l_inverse.cu's schedule
# ---------------------------------------------------------------------------

SOURCE = (KERNEL_DIR / "vp8l_inverse.cu").read_text()
MAX_ROWS = int(re.search(r"constexpr int kMaxRows = (\d+);", SOURCE)[1])


def test_model_reads_the_kernels_ring_slots():
    for line in ("tp = ring[j - 1][x & 3];",
                 "if (x > 0) tl = ring[j - 1][(x - 1) & 3];",
                 "tr = x + 1 < w ? ring[j - 1][(x + 1) & 3] : first;",
                 "ring[j][x & 3] = px;",
                 "const int steps = w + 2 * (rows - 1);",
                 "const int x = t - 2 * j;"):
        assert line in SOURCE, line


def _kernel_model(res, mode_img, bits, add_green, band):
    """The kernel on one image, step by step: thread j of a band owns row
    y0 + j and takes pixel x = t - 2j at step t; a step's ring writes are
    seen at the next step (the barrier).  Every ring read is checked to
    hold the pixel it stands for."""
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import (add_green_words,
                                                           add_pixels)
    from gowebp_tpu_torch.ops.lossless import apply_predictor

    h, w = res.shape
    tw = -(-w // (1 << bits))
    out = np.zeros((h, w), np.int64)        # what the kernel stores
    truth = {}                               # (y, x) -> pre-epilogue pixel

    def pred_of(mode, l, t, tl, tr):
        if mode > 13:
            return 0
        t_ = [torch.tensor([v], dtype=torch.int64) for v in (l, t, tl, tr)]
        return int(apply_predictor(mode, *t_)[0])

    def sub_green(v):
        g = (v >> 8) & 255
        return ((v & 0xFF00FF00) | ((((v >> 16) - g) & 255) << 16)
                | (((v & 255) - g) & 255))

    for y0 in range(0, h, band):
        rows = min(band, h - y0)
        ring = np.zeros((rows, 4), np.int64)
        ring_tag = -np.ones((rows, 4, 2), np.int64)   # (y, x) held
        left = first = 0
        lefts, firsts = [0] * rows, [0] * rows
        for t in range(w + 2 * (rows - 1)):
            writes = []
            for j in range(rows):
                x, y = t - 2 * j, y0 + j
                if not 0 <= x < w:
                    continue
                left, first = lefts[j], firsts[j]

                def above(i):
                    if j > 0:
                        assert tuple(ring_tag[j - 1, i & 3]) == (y - 1, i)
                        return int(ring[j - 1, i & 3])
                    v = int(out[y - 1, i])
                    return sub_green(v) if add_green else v

                if y == 0:
                    pred = 0xFF000000 if x == 0 else left
                else:
                    tp = above(x)
                    tl = above(x - 1) if x > 0 else 0
                    tr = above(x + 1) if x + 1 < w else first
                    if x == 0:
                        pred = tp
                    else:
                        mode = (int(mode_img[y >> bits, x >> bits]) >> 8) & 255
                        pred = pred_of(mode, left, tp, tl, tr)
                px = int(add_pixels(torch.tensor(int(res[y, x])),
                                    torch.tensor(pred)))
                writes.append((j, x, y, px))
                if x == 0:
                    firsts[j] = px
                lefts[j] = px
                truth[y, x] = px
                out[y, x] = int(add_green_words(torch.tensor(px))) \
                    if add_green else px
            for j, x, y, px in writes:       # seen after the barrier
                ring[j, x & 3] = px
                ring_tag[j, x & 3] = (y, x)
    return out


@pytest.mark.parametrize("add_green", [False, True])
@pytest.mark.parametrize("h,w,band", [(9, 7, 4), (5, 1, 2), (1, 6, 4),
                                      (12, 10, 5), (7, 9, MAX_ROWS)])
def test_kernel_schedule_model_equals_the_plain_version(h, w, band,
                                                        add_green):
    res, mode_img = _case(h * w + band, h, w, 2)
    want = predictor_inverse_plain(
        torch.from_numpy(res[:1].view(np.int32)),
        torch.from_numpy(mode_img.view(np.int32)), 2, add_green)[0]
    got = _kernel_model(res[0].astype(np.int64), mode_img, 2, add_green,
                        band)
    np.testing.assert_array_equal(
        got.astype(np.uint32), want.numpy().view(np.uint32))
