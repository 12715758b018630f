"""PyTorch port, VP8L (lossless) decode: the port's host decoder and its
inverse transforms vs the JAX package's and Pillow's (libwebp), bit for
bit.

Inputs: Pillow lossless files (methods, qualities, exact alpha, palettes
of every bundling width, colour caches, odd sizes), the JAX package's own
lossless encoder, and seeded residual planes for the transforms.  Nothing
here compiles a JAX function: both packages decode VP8L on the host.
"""

import io

import numpy as np
import pytest
from PIL import Image

import gowebp_tpu
from gowebp_tpu.config import EncoderConfig
from gowebp_tpu.models.vp8l import decoder as jdec
from gowebp_tpu.models.vp8l import transforms_np as jt
from gowebp_tpu_torch.container.riff import parse_riff
from gowebp_tpu_torch.entropy.bitio import BitReader
from gowebp_tpu_torch.errors import BitstreamError
from gowebp_tpu_torch.models.vp8l import decoder as pdec
from gowebp_tpu_torch.models.vp8l import transforms_np as pt
from gowebp_tpu_torch.utils.corpus import natural_image


def _lossless(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True, **kw)
    return buf.getvalue()


def _payload(data: bytes) -> bytes:
    return parse_riff(data).find(b"VP8L").payload


def _header(payload: bytes):
    """The top-level stream header as the port parses it: transforms
    [(kind, bits)], colour-cache bits."""
    w, h, _ = pdec.decode_vp8l_header(payload)
    br = BitReader(payload[1:])
    br.skip_bits(32)
    hdr = pdec._parse_stream_header(br, w, h, top_level=True)
    return [(t.kind, t.bits) for t in hdr.transforms], hdr.cache_bits


def _check(data: bytes):
    """Port == JAX package == Pillow on one lossless file."""
    payload = _payload(data)
    got = pdec.decode_vp8l(payload)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, jdec.decode_vp8l(payload))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(got, want)
    return got


# ---------------------------------------------------------------------------
# Whole files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 75, 100])
def test_pillow_methods_and_qualities(method, quality):
    img = natural_image(48, 40, seed=method + 1)
    _check(_lossless(img, method=method, quality=quality))


def test_exact_alpha():
    rng = np.random.default_rng(11)
    rgba = np.dstack([natural_image(36, 44, seed=4),
                      rng.integers(0, 256, (36, 44), dtype=np.uint8)])
    rgba[:6, :6, 3] = 0                         # RGB kept under alpha 0
    got = _check(_lossless(rgba, exact=True))
    np.testing.assert_array_equal(got, rgba)


@pytest.mark.parametrize("ncolors,bits", [(2, 3), (3, 2), (4, 2), (11, 1),
                                          (16, 1), (200, 0), (256, 0)])
def test_palette_bundling(ncolors, bits):
    """Colour indexing with 8, 4, 2 and 1 pixels bundled a packed pixel."""
    rng = np.random.default_rng(ncolors)
    pal = rng.integers(0, 256, (ncolors, 4), dtype=np.uint8)
    pal[:, 3] = rng.integers(1, 256, ncolors, dtype=np.uint8)
    img = pal[rng.integers(0, ncolors, (33, 49))]
    data = _lossless(img, exact=True)
    transforms, _ = _header(_payload(data))
    assert (3, bits) in transforms
    np.testing.assert_array_equal(_check(data), img)


@pytest.mark.parametrize("case", ["photo", "many_colours"])
def test_colour_cache(case):
    if case == "photo":
        data = _lossless(natural_image(64, 64, seed=3), method=4, quality=75)
    else:
        rng = np.random.default_rng(1)
        cols = rng.integers(0, 256, (600, 3), dtype=np.uint8)
        data = _lossless(cols[rng.integers(0, 600, (64, 64))], method=6,
                         quality=100)
    _, cache_bits = _header(_payload(data))
    assert cache_bits > 0
    _check(data)


@pytest.mark.parametrize("shape", [(1, 1), (1, 64), (17, 1), (33, 49)])
@pytest.mark.parametrize("kind", ["photo", "palette"])
def test_odd_sizes(shape, kind):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    if kind == "photo":
        img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    else:
        img = rng.integers(0, 2, shape + (1,), dtype=np.uint8).repeat(3, -1)
        img *= 255
    got = _check(_lossless(img, method=4))
    assert got.shape == shape + (4,)


@pytest.mark.parametrize("case", ["default", "method6", "method0", "alpha"])
def test_jax_package_lossless_files(case):
    img = natural_image(40, 56, seed=2)
    rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    kw = {"lossless": True}
    if case == "method6":
        kw = {"config": EncoderConfig(lossless=True, method=6, quality=100)}
    elif case == "method0":
        kw = {"config": EncoderConfig(lossless=True, method=0, quality=0)}
    elif case == "alpha":
        rgba[..., 3] = np.tile(np.arange(56, dtype=np.uint8) * 4 + 3, (40, 1))
    data = gowebp_tpu.encode_rgba(rgba, **kw)
    np.testing.assert_array_equal(_check(data), rgba)


# ---------------------------------------------------------------------------
# Inverse transforms, function by function
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(2026)


def _argb(shape):
    return RNG.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("mode", range(14))
def test_predictor_inverse_each_mode(mode, monkeypatch):
    h, w, bits = 9, 13, 2
    res = _argb((h, w))
    tiles = _argb((-(-h // 4), -(-w // 4)))
    tiles = (tiles & ~np.uint32(0xFF00)) | np.uint32(mode << 8)
    got = pt.predictor_inverse(res, tiles, bits)
    np.testing.assert_array_equal(got, jt.predictor_inverse(res, tiles, bits))
    # and the JAX package's pure-Python raster loop
    monkeypatch.setattr(jt, "_predictor_inverse_native", lambda *a: None)
    np.testing.assert_array_equal(got, jt.predictor_inverse(res, tiles, bits))


def test_predictor_inverse_mixed_tiles(monkeypatch):
    h, w, bits = 23, 37, 3
    res = _argb((h, w))
    tiles = _argb((-(-h // 8), -(-w // 8)))
    modes = RNG.integers(0, 14, tiles.shape).astype(np.uint32)
    tiles = (tiles & ~np.uint32(0xFF00)) | (modes << np.uint32(8))
    got = pt.predictor_inverse(res, tiles, bits)
    monkeypatch.setattr(jt, "_predictor_inverse_native", lambda *a: None)
    np.testing.assert_array_equal(got, jt.predictor_inverse(res, tiles, bits))


@pytest.mark.parametrize("bits", [2, 3, 5])
def test_color_transform_inverse(bits, monkeypatch):
    h, w = 19, 41
    argb = _argb((h, w))
    timg = _argb((-(-h // (1 << bits)), -(-w // (1 << bits))))
    got = pt.color_transform_inverse(argb, timg, bits)
    np.testing.assert_array_equal(
        got, jt.color_transform_inverse(argb, timg, bits))
    monkeypatch.setattr(jt, "_lib", lambda: None)      # the numpy version
    np.testing.assert_array_equal(
        got, jt.color_transform_inverse(argb, timg, bits))


def test_add_green_inverse(monkeypatch):
    argb = _argb((17, 29))
    got = pt.add_green_inverse(argb)
    np.testing.assert_array_equal(got, jt.add_green_inverse(argb))
    monkeypatch.setattr(jt, "_lib", lambda: None)
    np.testing.assert_array_equal(got, jt.add_green_inverse(argb))


@pytest.mark.parametrize("ncolors,bits", [(200, 0), (16, 1), (4, 2), (2, 3)])
def test_color_index_inverse(ncolors, bits):
    h, w = 7, 45
    packed_w = pt.subsample_size(w, bits)
    assert packed_w == jt.subsample_size(w, bits)
    packed = _argb((h, packed_w))                # indices beyond the palette
    palette = _argb((ncolors,))                  # decode as transparent black
    got = pt.color_index_inverse(packed, palette, w)
    assert got.shape == (h, w)
    np.testing.assert_array_equal(got,
                                  jt.color_index_inverse(packed, palette, w))


# ---------------------------------------------------------------------------
# Bad streams
# ---------------------------------------------------------------------------

def _outcome(fn, payload):
    try:
        return "ok", fn(payload)
    except Exception as e:                        # noqa: BLE001
        return type(e).__name__, None


def _corruptions():
    data = _payload(_lossless(natural_image(40, 48, seed=9), method=4))
    rng = np.random.default_rng(5)
    cases = [data[:n] for n in (0, 4, 5, 9, 20, len(data) // 3,
                                len(data) // 2, len(data) - 3)]
    for _ in range(10):
        b = bytearray(data)
        for p in rng.integers(5, len(b), 3):
            b[p] ^= int(rng.integers(1, 256))
        cases.append(bytes(b))
    cases.append(b"\x2e" + data[1:])              # bad signature
    cases.append(data[:4] + bytes([data[4] | 0xE0]) + data[5:])  # version
    return cases


@pytest.mark.parametrize("k", range(20))
def test_bad_streams_raise_as_the_jax_package(k):
    payload = _corruptions()[k]
    got = _outcome(pdec.decode_vp8l, payload)
    want = _outcome(jdec.decode_vp8l, payload)
    assert got[0] == want[0]
    if got[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        with pytest.raises(BitstreamError):
            pdec.decode_vp8l(payload)
