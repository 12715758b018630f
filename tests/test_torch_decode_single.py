"""PyTorch port, the single-file decode API (``decode`` in every mode,
``decode_rgba``, ``decode_rgb``, ``decode_into``, ``decode_yuv``,
``decode_yuva``, ``features``, ``DecoderConfig``) on ``device="cpu"``
against the JAX package's, bit for bit and exception class for exception
class.

The files are made by the JAX package's encoder (lossy, lossy + ALPH and
VP8L) from numpy images seeded with ``np.random.default_rng``, at 1x1,
33x17 and 64x48, plus a smooth q95 file whose flat-chroma MBs the chroma
dither reaches.
"""

import numpy as np
import pytest
import torch

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.container import riff as jriff
from gowebp_tpu.models.vp8 import decoder as jdec
from gowebp_tpu_torch.container import riff as priff
from gowebp_tpu_torch.models.vp8 import decoder as pdec

SIZES = [(1, 1), (33, 17), (64, 48)]
KINDS = ["lossy", "alph", "vp8l"]
MODES = ["RGBA", "BGRA", "ARGB", "RGB", "BGR", "rgbA", "bgrA", "Argb",
         "rgbA_4444", "RGB_565", "RGBA_4444"]
FILES = [f"{k}_{h}x{w}" for k in KINDS for h, w in SIZES]


def _image(h, w, seed, alpha):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([120 + 60 * np.sin(xx / 5), 110 + 50 * np.cos(yy / 4),
                    (3 * xx + 2 * yy) % 256], -1)
    rgb = (rgb + rng.normal(0, 12, rgb.shape)).clip(0, 255).astype(np.uint8)
    if not alpha:
        return rgb
    a = (255 * xx / max(w - 1, 1) + rng.integers(-30, 30, (h, w)))
    a[:h // 3, :w // 3] = 0                       # a hard edge
    return np.dstack([rgb, a.clip(0, 255).astype(np.uint8)])


_CACHE = {}


def _file(name):
    if name not in _CACHE:
        kind, size = name.split("_")
        h, w = map(int, size.split("x"))
        img = _image(h, w, seed=h * 100 + w, alpha=kind != "lossy")
        if kind == "vp8l":
            _CACHE[name] = gowebp_tpu.encode_rgba(img, lossless=True)
        else:
            _CACHE[name] = gowebp_tpu.encode_rgba(img, quality=70)
    return _CACHE[name]


def _dither_file():
    """A smooth 64x48 image at q95: uv_quant 4, flat-chroma MBs."""
    if "dither" not in _CACHE:
        yy, xx = np.mgrid[0:64, 0:48]
        img = np.stack([3 * xx, 2 * yy, xx + yy], -1).astype(np.uint8)
        _CACHE["dither"] = gowebp_tpu.encode_rgba(img, quality=95)
    return _CACHE["dither"]


def _same(want, got):
    assert type(got) is type(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _configs(h, w):
    """Every DecoderConfig field alone (name → kwargs), and crop + scale +
    flip together."""
    cl, ct = w // 3, h // 4
    cw, ch = max(1, w - cl - 1), max(1, h - ct - 2)
    crop = dict(use_cropping=True, crop_left=cl, crop_top=ct, crop_width=cw,
                crop_height=ch)
    return {
        "bypass_filtering": dict(bypass_filtering=True),
        "no_fancy_upsampling": dict(no_fancy_upsampling=True),
        "crop": crop,
        "scale_w": dict(use_scaling=True, scaled_width=w + 5),
        "scale_h": dict(use_scaling=True, scaled_height=max(1, h // 2)),
        "scale_both": dict(use_scaling=True, scaled_width=2 * w + 1,
                           scaled_height=max(1, h - 3)),
        "use_threads": dict(use_threads=True),
        "dithering_strength": dict(dithering_strength=100),
        "flip": dict(flip=True),
        "alpha_dithering_strength": dict(alpha_dithering_strength=100),
        "crop_scale_flip": dict(crop, use_scaling=True, scaled_width=w + 3,
                                flip=True),
    }


CONFIG_NAMES = list(_configs(8, 8))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FILES)
def test_decode_every_mode_matches_jax(name, mode):
    data = _file(name)
    _same(gowebp_tpu.decode(data, mode=mode),
          gowebp_tpu_torch.decode(data, mode=mode, device="cpu"))


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("name", FILES)
def test_decode_every_config_field_matches_jax(name, cfg):
    data = _file(name)
    f = gowebp_tpu.features(data)
    kw = _configs(f.height, f.width)[cfg]
    _same(gowebp_tpu.decode(data, gowebp_tpu.DecoderConfig(**kw)),
          gowebp_tpu_torch.decode(data, gowebp_tpu_torch.DecoderConfig(**kw),
                                  device="cpu"))


@pytest.mark.parametrize("strength", [30, 50, 100])
@pytest.mark.parametrize("mode", ["RGBA", "bgrA", "RGB_565"])
def test_chroma_dither_matches_jax(strength, mode):
    data = _dither_file()
    want = gowebp_tpu.decode(
        data, gowebp_tpu.DecoderConfig(dithering_strength=strength), mode)
    got = gowebp_tpu_torch.decode(
        data, gowebp_tpu_torch.DecoderConfig(dithering_strength=strength),
        mode, device="cpu")
    _same(want, got)
    if strength == 100:
        assert not np.array_equal(got, gowebp_tpu_torch.decode(
            data, mode=mode, device="cpu"))


@pytest.mark.parametrize("name", FILES)
def test_decode_rgba_rgb_and_features_match_jax(name):
    data = _file(name)
    _same(gowebp_tpu.decode_rgba(data),
          gowebp_tpu_torch.decode_rgba(data, device="cpu"))
    _same(gowebp_tpu.decode_rgb(data),
          gowebp_tpu_torch.decode_rgb(data, device="cpu"))
    want, got = gowebp_tpu.features(data), gowebp_tpu_torch.features(data)
    assert vars(got) == vars(want)
    assert got.format == ("lossless" if name.startswith("vp8l") else "lossy")


@pytest.mark.parametrize("name", FILES)
def test_decode_into_a_strided_view_matches_jax(name):
    data = _file(name)
    f = gowebp_tpu.features(data)
    for mode, c in (("RGBA", 4), ("BGR", 3), ("RGB_565", 2)):
        want = np.zeros((f.height + 4, 2 * f.width + 3, c), np.uint8)
        got = want.copy()
        kw = {} if c != 2 else {"mode": mode}
        out_w = gowebp_tpu.decode_into(
            data, want[2:2 + f.height, 1::2][:, :f.width], **kw)
        out_g = gowebp_tpu_torch.decode_into(
            data, got[2:2 + f.height, 1::2][:, :f.width], device="cpu", **kw)
        np.testing.assert_array_equal(out_g, out_w)
        np.testing.assert_array_equal(got, want)    # the rest untouched
    cfg = _configs(f.height, f.width)["crop_scale_flip"]
    want = gowebp_tpu.decode(data, gowebp_tpu.DecoderConfig(**cfg), "bgrA")
    out = np.empty_like(want)
    gowebp_tpu_torch.decode_into(data, out,
                                 gowebp_tpu_torch.DecoderConfig(**cfg),
                                 "bgrA", device="cpu")
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "channels", "shape",
                                 "packed_without_mode", "bad_mode"])
def test_decode_into_raises_as_jax(bad):
    data = _file("alph_33x17")
    out = {"dtype": np.zeros((33, 17, 4), np.int16),
           "ndim": np.zeros((33, 17), np.uint8),
           "channels": np.zeros((33, 17, 4), np.uint8),
           "shape": np.zeros((33, 16, 4), np.uint8),
           "packed_without_mode": np.zeros((33, 17, 2), np.uint8),
           "bad_mode": np.zeros((33, 17, 4), np.uint8)}[bad]
    mode = {"channels": "RGB", "bad_mode": "YUV"}.get(bad)
    with pytest.raises(ValueError):
        gowebp_tpu.decode_into(data, out.copy(), mode=mode)
    with pytest.raises(ValueError):
        gowebp_tpu_torch.decode_into(data, out.copy(), mode=mode,
                                     device="cpu")


@pytest.mark.parametrize("name", [n for n in FILES
                                  if not n.startswith("vp8l")])
def test_decode_yuv_and_yuva_match_jax(name):
    data = _file(name)
    for want, got in zip(gowebp_tpu.decode_yuv(data),
                         gowebp_tpu_torch.decode_yuv(data, device="cpu")):
        np.testing.assert_array_equal(got, want)
    f = gowebp_tpu.features(data)
    for kw in [{}] + list(_configs(f.height, f.width).values()):
        want = gowebp_tpu.decode_yuva(data, gowebp_tpu.DecoderConfig(**kw))
        got = gowebp_tpu_torch.decode_yuva(
            data, gowebp_tpu_torch.DecoderConfig(**kw), device="cpu")
        assert (got[3] is None) == (want[3] is None) == (not name.startswith(
            "alph"))
        for g, w in zip(got, want):
            if w is not None:
                _same(np.ascontiguousarray(w), g)


def test_decode_yuva_with_chroma_dither_matches_jax():
    data = _dither_file()
    for s in (50, 100):
        want = gowebp_tpu.decode_yuva(
            data, gowebp_tpu.DecoderConfig(dithering_strength=s))
        got = gowebp_tpu_torch.decode_yuva(
            data, gowebp_tpu_torch.DecoderConfig(dithering_strength=s),
            device="cpu")
        for g, w in zip(got[:3], want[:3]):
            _same(w, g)


def test_decode_yuv_matches_the_jax_device_decode():
    """The port's decode_yuv at B=1 (recon_frame) against the JAX
    package's device path, decode_vp8_yuv_jax."""
    for name in ("lossy_33x17", "alph_64x48"):
        payload = jriff.parse_riff(_file(name)).find(b"VP8 ").payload
        want = jdec.decode_vp8_yuv_jax(payload)
        got = gowebp_tpu_torch.decode_yuv(_file(name), device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# Exceptions
# ---------------------------------------------------------------------------

def _outcome(fn, *a, **kw):
    try:
        return "ok", fn(*a, **kw)
    except Exception as e:                       # noqa: BLE001
        return "raise", type(e).__name__


def _same_outcome(ref_fn, port_fn, *a, **kw):
    want = _outcome(ref_fn, *a)
    got = _outcome(port_fn, *a, device="cpu", **kw)
    assert got[0] == want[0], (want, got)
    if want[0] == "raise":
        assert got[1] == want[1]
    elif isinstance(want[1], jriff.WebPFeatures):
        assert vars(got[1]) == vars(want[1])
    else:
        w, g = want[1], got[1]
        for x, y in (zip(w, g) if isinstance(w, tuple) else [(w, g)]):
            assert (x is None and y is None) or np.array_equal(x, y)
    return want[0]


@pytest.mark.parametrize("cfg", [
    dict(use_cropping=True, crop_left=10, crop_top=0, crop_width=10,
         crop_height=5),
    dict(use_cropping=True, crop_width=0, crop_height=5),
    dict(use_cropping=True, crop_left=-1, crop_width=4, crop_height=4),
    dict(use_scaling=True),
    dict(dithering_strength=101),
    dict(alpha_dithering_strength=-1),
])
@pytest.mark.parametrize("name", ["lossy_33x17", "alph_33x17", "vp8l_33x17"])
def test_bad_config_raises_as_jax(name, cfg):
    data = _file(name)
    for ref, port in ((gowebp_tpu.decode, gowebp_tpu_torch.decode),
                      (gowebp_tpu.decode_yuva, gowebp_tpu_torch.decode_yuva)):
        assert _same_outcome(lambda d: ref(d, gowebp_tpu.DecoderConfig(**cfg)),
                             lambda d, device: port(
                                 d, gowebp_tpu_torch.DecoderConfig(**cfg),
                                 device=device), data) == "raise"


def test_bad_mode_and_missing_chunks_raise_as_jax():
    data = _file("lossy_33x17")
    for mode in ("YUV", "rgba", ""):
        with pytest.raises(ValueError):
            gowebp_tpu.decode(data, mode=mode)
        with pytest.raises(ValueError):
            gowebp_tpu_torch.decode(data, mode=mode, device="cpu")
    # a RIFF/WEBP file with no image chunk; a VP8L file asked for YUV
    empty = jriff.assemble([jriff.Chunk(b"EXIF", b"abcd")])
    for ref, port in ((gowebp_tpu.decode, gowebp_tpu_torch.decode),
                      (gowebp_tpu.decode_yuv, gowebp_tpu_torch.decode_yuv),
                      (gowebp_tpu.decode_yuva, gowebp_tpu_torch.decode_yuva)):
        assert _same_outcome(ref, port, empty) == "raise"
        assert _same_outcome(ref, port, b"RIFF") == "raise"
    for ref, port in ((gowebp_tpu.decode_yuv, gowebp_tpu_torch.decode_yuv),
                      (gowebp_tpu.decode_yuva, gowebp_tpu_torch.decode_yuva)):
        assert _same_outcome(ref, port, _file("vp8l_33x17")) == "raise"
    for bad in (empty, b"RIFF", b"RIFF\x04\x00\x00\x00WEBQ"):
        assert _same_outcome(gowebp_tpu.features,
                             lambda d, device: gowebp_tpu_torch.features(d),
                             bad) == "raise"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", ["lossy_33x17", "alph_33x17", "vp8l_33x17",
                                  "lossy_64x48"])
def test_truncations_and_byte_flips_raise_or_decode_as_jax(name, seed):
    """The same pixels or the same exception class, for truncated files and
    files with one byte changed."""
    data = _file(name)
    rng = np.random.default_rng(seed)
    muts = [data[:int(k)] for k in rng.integers(0, len(data), 4)]
    for _ in range(8):
        b = bytearray(data)
        b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        muts.append(bytes(b))
    for m in muts:
        _same_outcome(gowebp_tpu.decode, gowebp_tpu_torch.decode, m)
    for m in muts[:3] + muts[-3:]:
        _same_outcome(gowebp_tpu.features,
                      lambda d, device: gowebp_tpu_torch.features(d), m)
        if not name.startswith("vp8l"):
            _same_outcome(gowebp_tpu.decode_yuva,
                          gowebp_tpu_torch.decode_yuva, m)


# ---------------------------------------------------------------------------
# Chroma dithering pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amps", [(8,), (4, 255), (1, 77, 200, 31)])
def test_vp8_random_matches_jax(amps):
    want, got = jdec.VP8Random(), pdec.VP8Random()
    for i in range(400):
        a = amps[i % len(amps)]
        assert got.bits2(8, a) == want.bits2(8, a)
    # raw draws in bulk advance the state as single draws do
    vals = got.raw(1000)
    np.testing.assert_array_equal(
        pdec._centre(vals, 8, 99), [want.bits2(8, 99) for _ in range(1000)])
    assert (got.tab, got.i1, got.i2) == (want.tab, want.i1, want.i2)


@pytest.mark.parametrize("strength", [-5, 0, 1, 30, 50, 99, 100, 150])
@pytest.mark.parametrize("quality", [60, 90, 95, 100])
def test_dither_amps_and_uv_quant_match_jax(quality, strength):
    yy, xx = np.mgrid[0:32, 0:32]
    img = np.stack([4 * xx, 5 * yy, xx + yy], -1).astype(np.uint8)
    payload = jriff.parse_riff(gowebp_tpu.encode_rgba(
        img, quality=quality)).find(b"VP8 ").payload
    want, _ = jdec.parse_frame_header(payload)
    got, _ = pdec.parse_frame_header(payload)
    assert [m.uv_quant for m in got.dqm] == [m.uv_quant for m in want.dqm]
    assert pdec._dither_amps(got, strength) == jdec._dither_amps(want,
                                                                 strength)


def test_dither_deltas_match_the_reference_raster_dither():
    """dither_deltas' planes equal the reference's raster-order
    _apply_dithering on the same symbols (every MB of a flat image)."""
    payload = priff.parse_riff(_dither_file()).find(b"VP8 ").payload
    st, _, modes = pdec.decode_vp8_symbols(payload)
    jst, _ = jdec.parse_frame_header(payload)
    amps = jdec._dither_amps(jst, 100)
    assert modes[:, 4].any()
    mbs = [[type("MB", (), {"dither": int(modes[y * st.mb_w + x, 4]),
                            "segment": int(modes[y * st.mb_w + x, 2])})
            for x in range(st.mb_w)] for y in range(st.mb_h)]
    U = np.full((8 * st.mb_h, 8 * st.mb_w), 128, np.int32)
    V = U.copy()
    jdec._apply_dithering(jst, mbs, U, V, amps)
    du, dv = pdec.dither_deltas(st, modes, 100)
    np.testing.assert_array_equal(128 + du, U)
    np.testing.assert_array_equal(128 + dv, V)
    assert pdec.dither_deltas(st, modes, 0) is None


def test_output_options_run_on_the_tensor_device():
    """apply_output_options and the rescaler keep a tensor's device and
    give the reference's numpy pixels."""
    from gowebp_tpu.decode_options import _rescale as jrescale
    from gowebp_tpu_torch.decode_options import _rescale, apply_output_options

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (13, 21, 4), dtype=np.uint8)
    for sw, sh in ((1, 1), (21, 13), (40, 7), (5, 30)):
        got = _rescale(torch.from_numpy(img), sw, sh)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), jrescale(img, sw, sh))
    cfg = dict(use_cropping=True, crop_left=2, crop_top=3, crop_width=9,
               crop_height=7, use_scaling=True, scaled_height=11, flip=True)
    want = gowebp_tpu.decode_options.apply_output_options(
        img, gowebp_tpu.DecoderConfig(**cfg))
    got = apply_output_options(torch.from_numpy(img),
                               gowebp_tpu_torch.DecoderConfig(**cfg))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
