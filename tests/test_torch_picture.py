"""PyTorch port, the picture helpers (``picture_view``, ``picture_crop``,
``picture_rescale``) and ``decode_into`` on ``device="cpu"``: the cases of
tests/test_picture.py, each held against the JAX package's function on
the same seeded inputs, bit for bit (integer math, tolerance 0), and the
same exception class on bad input.
"""

import io

import numpy as np
import pytest
from PIL import Image

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.errors import WebPError as JWebPError
from gowebp_tpu_torch import (decode_into, picture_crop, picture_rescale,
                              picture_view)
from gowebp_tpu_torch.errors import WebPError


def _img(h=64, w=80, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 50, (h, w, c)), 0, 255).astype(np.uint8)


def _rescale_both(im, *args, **kw):
    got = picture_rescale(im, *args, device="cpu", **kw)
    want = gowebp_tpu.picture_rescale(im, *args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


class TestViewCrop:
    def test_view_shares_memory(self):
        im = _img()
        v = picture_view(im, 8, 4, 16, 24)
        np.testing.assert_array_equal(
            v, gowebp_tpu.picture_view(im, 8, 4, 16, 24))
        assert v.shape == (24, 16, 3)
        v[0, 0, 0] = 7
        assert im[4, 8, 0] == 7

    def test_crop_copies(self):
        im = _img()
        c = picture_crop(im, 8, 4, 16, 24)
        np.testing.assert_array_equal(
            c, gowebp_tpu.picture_crop(im, 8, 4, 16, 24))
        np.testing.assert_array_equal(c, im[4:28, 8:24])
        c[0, 0, 0] = im[4, 8, 0] ^ 1
        assert im[4, 8, 0] != c[0, 0, 0]
        assert c.base is None and c.flags.c_contiguous

    def test_bad_rect_raises(self):
        im = _img()
        for rect in [(-1, 0, 8, 8), (0, 0, 0, 8), (76, 0, 8, 8),
                     (0, 60, 8, 8)]:
            with pytest.raises(JWebPError):
                gowebp_tpu.picture_view(im, *rect)
            with pytest.raises(WebPError):
                picture_view(im, *rect)
            with pytest.raises(WebPError):
                picture_crop(im, *rect)

    def test_crop_then_encode_roundtrip(self):
        im = _img(96, 96)
        c = picture_crop(im, 16, 32, 48, 32)
        data = gowebp_tpu_torch.encode_rgba(c, lossless=True, device="cpu")
        assert data == gowebp_tpu.encode_rgba(
            gowebp_tpu.picture_crop(im, 16, 32, 48, 32), lossless=True)
        out = gowebp_tpu_torch.decode_rgba(data, device="cpu")
        assert np.array_equal(out[..., :3], c)


class TestRescale:
    def test_downscale_matches_decoder_rescaler(self):
        """The same fixed-point scaler as the decode's scale option."""
        from gowebp_tpu.decode_options import _rescale

        im = _img(64, 64, 4)
        im[..., 3] = 255
        got = _rescale_both(im, 24, 40)
        np.testing.assert_array_equal(got, _rescale(im, 24, 40))

    def test_aspect_preserving_zero_dim(self):
        im = _img(60, 90)
        assert _rescale_both(im, width=30).shape == (20, 30, 3)
        assert _rescale_both(im, height=30).shape == (30, 45, 3)

    def test_alpha_premultiplied_scaling(self):
        """A transparent red region must not bleed red into opaque
        neighbours when downscaling."""
        im = np.zeros((32, 32, 4), np.uint8)
        im[:, :16] = (255, 0, 0, 0)       # transparent red
        im[:, 16:] = (0, 255, 0, 255)     # opaque green
        out = _rescale_both(im, 8, 8)
        right = out[:, 5:]                 # solidly inside the green half
        assert (right[..., 3] == 255).all()
        assert (right[..., 0] == 0).all(), "red bled across alpha edge"
        soft = _img(37, 29, 4, seed=3)     # every alpha level, odd sizes
        _rescale_both(soft, 50, 11)
        _rescale_both(soft, 0, 74)

    def test_upscale_shape(self):
        im = _img(16, 16)
        assert _rescale_both(im, 33, 47).shape == (47, 33, 3)
        same = _rescale_both(im, 16, 16)
        assert same is not im and np.array_equal(same, im)
        for bad in ((np.zeros((4, 4), np.uint8), 2, 2), (im, 0, 0),
                    (np.zeros((4, 4, 2), np.uint8), 2, 2)):
            with pytest.raises(JWebPError):
                gowebp_tpu.picture_rescale(*bad)
            with pytest.raises(WebPError):
                picture_rescale(*bad, device="cpu")


class TestDecodeInto:
    def test_strided_window(self):
        im = _img(40, 56)
        data = gowebp_tpu.encode_rgba(im, lossless=True)
        frames = []
        for dec in (lambda d, w: decode_into(d, w, device="cpu"),
                    gowebp_tpu.decode_into):
            frame = np.zeros((100, 100, 4), np.uint8)
            window = frame[10:50, 20:76]   # strided view, rows 100*4 apart
            assert dec(data, window) is window
            frames.append(frame)
        np.testing.assert_array_equal(frames[0], frames[1])
        np.testing.assert_array_equal(frames[0][10:50, 20:76, :3], im)
        assert (frames[0][:10] == 0).all() and (frames[0][50:] == 0).all()

    def test_rgb_and_mode_inference(self):
        im = _img(24, 24)
        data = gowebp_tpu.encode_rgba(im, lossless=True)
        out3 = np.empty((24, 24, 3), np.uint8)
        decode_into(data, out3, device="cpu")
        want = np.empty((24, 24, 3), np.uint8)
        gowebp_tpu.decode_into(data, want)
        np.testing.assert_array_equal(out3, want)
        np.testing.assert_array_equal(out3, im)

    def test_shape_mismatch_raises(self):
        im = _img(24, 24)
        data = gowebp_tpu.encode_rgba(im, lossless=True)
        for shape in ((25, 24, 4), (24, 24, 2)):
            with pytest.raises(ValueError):
                gowebp_tpu.decode_into(data, np.empty(shape, np.uint8))
            with pytest.raises(ValueError):
                decode_into(data, np.empty(shape, np.uint8), device="cpu")

    def test_with_scale_option(self):
        im = _img(64, 64)
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, "WEBP", quality=85)
        outs = []
        for dec, cfg in (
                (lambda d, o, c: decode_into(d, o, config=c, device="cpu"),
                 gowebp_tpu_torch.DecoderConfig),
                (lambda d, o, c: gowebp_tpu.decode_into(d, o, config=c),
                 gowebp_tpu.DecoderConfig)):
            out = np.empty((32, 32, 4), np.uint8)
            dec(buf.getvalue(), out, cfg(use_scaling=True, scaled_width=32,
                                         scaled_height=32))
            outs.append(out)
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0][..., 3].min() == 255


def test_rescale_default_device_is_cuda(monkeypatch):
    """``device`` None means CUDA: without it the call raises before any
    work (the view and crop are host-only and take no device)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        picture_rescale(_img(), 8, 8)
