"""The reference decodes every kind of still file as libwebp does, byte for
byte: lossy files with an ALPH plane, lossless files of every effort,
palettes with each pixel bundling, raw ALPH planes under each filter, long
backward references, odd sizes.  libwebp is the one that Pillow carries."""

import io

import numpy as np
import pytest

from webpbench.alpha_models import cutout
from webpbench.corpus import natural_image
from webpbench.vp8ref import StreamError, decode_rgba, read_still


def _encode(a, **options):
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(a).save(b, "WEBP", **options)
    return b.getvalue()


def _libwebp(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same_as_libwebp(data):
    got, want = decode_rgba(data), _libwebp(data)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), int((got != want).sum())


def _rgba(h, w, seed):
    return np.dstack([natural_image(h, w, seed), cutout(h, w, seed)])


@pytest.mark.parametrize("h,w,alpha_quality,exact", [
    (96, 128, 100, False), (96, 128, 100, True), (96, 128, 40, False),
    (96, 128, 40, True), (17, 9, 100, False), (77, 133, 40, True)])
def test_lossy_cutouts_with_alph_decode_as_libwebp(h, w, alpha_quality,
                                                   exact):
    data = _encode(_rgba(h, w, h * w), quality=75, method=4,
                   alpha_quality=alpha_quality, exact=exact)
    still = read_still(data)
    assert still.kind == "vp8" and still.alpha is not None
    # alpha_quality < 100 codes quantized levels, flagged as pre-processed
    assert (still.alpha[0] >> 4) & 3 == int(alpha_quality < 100)
    _same_as_libwebp(data)


@pytest.mark.parametrize("h,w,channels,method,quality,exact", [
    *[(96, 128, 3, m, q, False) for m in (0, 4, 6) for q in (0, 75, 100)],
    (17, 9, 3, 4, 75, False), (77, 133, 3, 4, 75, False),
    (96, 128, 4, 4, 75, False), (96, 128, 4, 4, 75, True),
    (77, 133, 4, 6, 100, True)])
def test_lossless_files_decode_as_libwebp(h, w, channels, method, quality,
                                          exact):
    src = _rgba(h, w, 5) if channels == 4 else natural_image(h, w, 5)
    data = _encode(src, lossless=True, method=method, quality=quality,
                   exact=exact)
    assert read_still(data).kind == "vp8l"
    _same_as_libwebp(data)
    if exact:                           # every byte kept, under alpha 0 too
        assert np.array_equal(decode_rgba(data)[..., :channels], src)


@pytest.mark.parametrize("colours", [2, 3, 12, 200])
def test_palettes_decode_as_libwebp(colours):
    """Colour indexing: 8, 4, 2 and 1 pixels a byte; 53 is a width that
    no bundling divides."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    img = pal[rng.integers(0, colours, (40, 53))]
    data = _encode(img, lossless=True, method=4, quality=75)
    _same_as_libwebp(data)
    assert np.array_equal(decode_rgba(data)[..., :3], img)


def _forward_filter(method, a):
    """An ALPH plane's filter as the container specification states it."""
    a = a.astype(np.int64)
    res = a.copy()
    res[0, 1:] = a[0, 1:] - a[0, :-1]
    res[1:, 0] = a[1:, 0] - a[:-1, 0]
    if method == 1:
        res[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        res[1:, 1:] = a[1:, 1:] - a[:-1, 1:]
    else:
        pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        res[1:, 1:] = a[1:, 1:] - pred
    return (res & 255).astype(np.uint8)


def _with_alph(data, body):
    out = b""
    pos = 12
    while pos < len(data):
        tag = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        chunk = body if tag == b"ALPH" else data[pos + 8:pos + 8 + size]
        out += (tag + len(chunk).to_bytes(4, "little") + chunk
                + b"\0" * (len(chunk) & 1))
        pos += 8 + size + (size & 1)
    return b"RIFF" + (4 + len(out)).to_bytes(4, "little") + b"WEBP" + out


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_raw_alph_planes_under_each_filter_decode_as_libwebp(method):
    h, w = 33, 47
    a = cutout(h, w, 3)
    data = _encode(_rgba(h, w, 3), quality=75, method=4)
    raw = bytes([method << 2]) + (
        a if method == 0 else _forward_filter(method, a)).tobytes()
    data = _with_alph(data, raw)
    _same_as_libwebp(data)
    assert np.array_equal(decode_rgba(data)[..., 3], a)


@pytest.mark.parametrize("method", [4, 6])
def test_short_backward_references_decode_as_libwebp(method):
    """Rows that repeat earlier rows at small 2-D offsets, so the encoder
    codes its distances through the 120-entry distance map."""
    rng = np.random.default_rng(method)
    img = np.zeros((64, 80, 3), np.uint8)
    img[:8] = rng.integers(0, 256, (8, 80, 3))
    for y in range(8, 64):
        img[y] = np.roll(img[y - rng.integers(1, 8)], rng.integers(-8, 9),
                         axis=0)
        noisy = rng.random(80) < 0.1
        img[y][noisy] = rng.integers(0, 256, (noisy.sum(), 3))
    _same_as_libwebp(_encode(img, lossless=True, method=method, quality=100))


@pytest.mark.parametrize("tag", [b"ANIM", b"ANMF"])
def test_animations_are_refused(tag):
    body = (b"WEBPVP8X" + (10).to_bytes(4, "little") + bytes(10) + tag
            + bytes(4))
    data = b"RIFF" + len(body).to_bytes(4, "little") + body
    with pytest.raises(StreamError):
        read_still(data)
