"""PyTorch port, ALPH decode and the VP8X container check: the port's
``decode_alpha`` (native unfilter, float64 level smoothing) vs the JAX
package's, bit for bit, and the batch decode's alpha planes wired into the
yuv420_to_rgba kernel's alpha input.

ALPH payloads come from the JAX package's own ``encode_alpha``; lossy +
ALPH files from Pillow (libwebp).  Only the wiring test decodes through the
batch path, on the CPU, with no JAX function compiled.
"""

import importlib
import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import gowebp_tpu
from gowebp_tpu.container import riff as jriff
from gowebp_tpu.models.vp8 import alpha as ja
from gowebp_tpu_torch import decode_rgba_batch
from gowebp_tpu_torch.container import riff as priff
from gowebp_tpu_torch.errors import BitstreamError
from gowebp_tpu_torch.models.vp8 import alpha as pa
from gowebp_tpu_torch.utils.corpus import natural_image

pdecode = importlib.import_module("gowebp_tpu_torch.decode")


def _plane(h, w, seed):
    """A smooth alpha ramp with a hard-edged disc and some noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = 255.0 * xx / max(w - 1, 1)
    a[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 3) ** 2] = 0
    a += rng.normal(0, 6, (h, w))
    return np.clip(a, 0, 255).astype(np.uint8)


def _payload(plane, method, filter_m, pre):
    """The JAX package's ALPH payload; pre-processing 1 quantizes the
    levels (quality 40) and sets the header's bits 4-5 to 1."""
    p = ja.encode_alpha(plane, method=method, filter_m=filter_m,
                        quality=40 if pre else 100)
    return bytes([p[0] | (pre << 4)]) + p[1:]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:                        # noqa: BLE001
        return type(e).__name__, None


# ---------------------------------------------------------------------------
# decode_alpha
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre", [0, 1])
@pytest.mark.parametrize("filter_m", [0, 1, 2, 3])
@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("shape", [(17, 5), (33, 49), (256, 256)])
def test_decode_alpha_matches_jax(shape, method, filter_m, pre):
    plane = _plane(*shape, seed=shape[0] + 7 * filter_m)
    payload = _payload(plane, method, filter_m, pre)
    h, w = shape
    got = pa.decode_alpha(payload, w, h)
    want = ja.decode_alpha(payload, w, h)
    assert got.shape == (h, w) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if not pre:
        np.testing.assert_array_equal(got, plane)


@pytest.mark.parametrize("filter_m", [1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (31, 45)])
def test_unfilter_matches_jax(shape, filter_m):
    """The native inverse filters against the JAX package's row loops, on
    random (filtered) data."""
    data = np.random.default_rng(filter_m).integers(0, 256, shape,
                                                    dtype=np.uint8)
    got = pa._unfilter(filter_m, data)
    np.testing.assert_array_equal(got, ja._unfilter(filter_m, data))
    assert got is not data


@pytest.mark.parametrize("levels", [1, 2, 5, 16, 17])
def test_dequantize_levels_matches_jax(levels):
    rng = np.random.default_rng(levels)
    values = np.sort(rng.choice(256, levels, replace=False)).astype(np.uint8)
    plane = values[rng.integers(0, levels, (23, 31))]
    got = pa.dequantize_levels(plane)
    np.testing.assert_array_equal(got, ja.dequantize_levels(plane))


@pytest.mark.parametrize("payload", [
    b"",                                         # empty chunk
    bytes([0xC0]) + bytes(20),                   # reserved bits
    bytes([0x40]) + bytes(20),
    bytes([0x02]) + bytes(20),                   # method 2
    bytes([0x03]) + bytes(20),                   # method 3
    bytes([0x00]) + bytes(19),                   # raw data one byte short
    bytes([0x01]) + b"\xff" * 3,                 # a bad VP8L stream
])
def test_bad_alph_raises_in_both(payload):
    got = _outcome(pa.decode_alpha, payload, 5, 4)
    want = _outcome(ja.decode_alpha, payload, 5, 4)
    assert got[0] == want[0] == "BitstreamError"
    with pytest.raises(BitstreamError):
        pa.decode_alpha(payload, 5, 4)


# ---------------------------------------------------------------------------
# The VP8X chunk
# ---------------------------------------------------------------------------

def _lossy(rgba, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "WEBP", quality=80, **kw)
    return buf.getvalue()


def _with_vp8x(vp8x_payload: bytes, vp8_file: bytes) -> bytes:
    """A VP8X file: the given VP8X payload, then the lossy file's chunks."""
    body = (b"VP8X" + struct.pack("<I", len(vp8x_payload)) + vp8x_payload
            + b"\x00" * (len(vp8x_payload) & 1) + vp8_file[12:])
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def test_short_vp8x_raises_in_both_packages():
    data = _with_vp8x(b"\x00" * 4, _lossy(natural_image(16, 16, seed=1)))
    with pytest.raises(BitstreamError, match="VP8X"):
        priff.parse_riff(data)
    with pytest.raises(BitstreamError):
        decode_rgba_batch([data], device="cpu")
    with pytest.raises(gowebp_tpu.errors.BitstreamError):
        gowebp_tpu.decode_rgba_batch([data])
    with pytest.raises(gowebp_tpu.errors.BitstreamError):
        gowebp_tpu.decode_rgba(data)


def test_vp8x_fields_match_jax():
    rgba = np.dstack([natural_image(24, 40, seed=2), _plane(24, 40, seed=3)])
    good = _with_vp8x(struct.pack("<I", 0x10) + bytes([39, 0, 0, 23, 0, 0]),
                      _lossy(rgba[..., :3]))
    for data in (_lossy(rgba), good):
        a, b = priff.parse_riff(data), jriff.parse_riff(data)
        assert a.has_vp8x and (a.has_vp8x, a.vp8x_flags, a.canvas_width,
                               a.canvas_height) == (
            b.has_vp8x, b.vp8x_flags, b.canvas_width, b.canvas_height)
        assert (a.canvas_width, a.canvas_height) == (40, 24)


# ---------------------------------------------------------------------------
# The batch decode's alpha wiring
# ---------------------------------------------------------------------------

def test_alph_groups_feed_the_kernels_alpha_input(monkeypatch):
    """On the CPU the ALPH group's planes reach the plain version's
    ``alpha``, as one contiguous (B, H, W) view of the group's upload;
    files without ALPH keep their own group and pass None."""
    calls = []
    real = pdecode.yuv420_to_rgba

    def spy(y, u, v, height, width, alpha=None):
        calls.append(None if alpha is None else alpha.clone())
        if alpha is not None:
            assert alpha.is_contiguous() and alpha.dtype == torch.uint8
            assert alpha.storage_offset() % 16 == 0
        return real(y, u, v, height, width, alpha)

    monkeypatch.setattr(pdecode, "yuv420_to_rgba", spy)
    planes = [_plane(24, 40, seed=s) for s in (4, 5)]
    datas = [_lossy(np.dstack([natural_image(24, 40, seed=s), a]))
             for s, a in zip((6, 7), planes)]
    datas.insert(1, _lossy(natural_image(24, 40, seed=8)))
    got = decode_rgba_batch(datas, device="cpu")
    assert len(calls) == 2
    assert calls[0] is None or calls[1] is None
    alpha = calls[0] if calls[0] is not None else calls[1]
    assert tuple(alpha.shape) == (2, 24, 40)
    for k, i in enumerate((0, 2)):
        np.testing.assert_array_equal(alpha[k].numpy(), got[i][..., 3])
        np.testing.assert_array_equal(got[i][..., 3], planes[k])
        want = np.asarray(Image.open(io.BytesIO(datas[i])).convert("RGBA"))
        np.testing.assert_array_equal(got[i], want)
    assert (got[1][..., 3] == 255).all()
