"""PyTorch port, batch lossy decode: each module of the decode path vs
the JAX package on the same seeded inputs, bit for bit.

The .webp inputs are made from seeded NumPy images, by Pillow (libwebp)
or by the JAX package's own encoder.  The JAX recon compiles once per
frame shape, so the cases share a few shapes.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import gowebp_tpu
from gowebp_tpu.config import EncoderConfig
from gowebp_tpu.container import riff as jriff
from gowebp_tpu.models.vp8 import decoder as jdec
from gowebp_tpu.ops import vp8_recon_jax as jrecon
from gowebp_tpu.ops import yuv_jax
from gowebp_tpu.ops.pallas.decode_post import yuv420_to_rgba_pallas
from gowebp_tpu_torch import decode_rgba_batch
from gowebp_tpu_torch.container import riff as priff
from gowebp_tpu_torch.errors import BitstreamError
from gowebp_tpu_torch.models.vp8 import decoder as pdec
from gowebp_tpu_torch.ops import vp8_recon as precon
from gowebp_tpu_torch.ops import yuv as pyuv
from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import (yuv420_to_rgba,
                                                         yuv420_to_rgba_plain)

RNG = np.random.default_rng(2026)


def _photo(shape, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return np.stack([
        np.clip(120 + 60 * np.sin(xx / 9) + rng.normal(0, 10, shape), 0, 255),
        np.clip(110 + 50 * np.cos(yy / 7), 0, 255),
        ((xx + yy) % 256).astype(float)], -1).astype(np.uint8)


def _pillow(shape, quality=65, seed=3, **kw):
    buf = io.BytesIO()
    Image.fromarray(_photo(shape, seed)).save(buf, "WEBP", quality=quality,
                                             **kw)
    return buf.getvalue()


def _jax_encoded(cfg):
    img = _photo((72, 88), seed=2)
    rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    return gowebp_tpu.encode_rgba(rgba, config=cfg)


# The filter configs of tests/test_vp8_recon_jax.py, plus filter off.
CONFIGS = {
    "complex": EncoderConfig(quality=75, method=4),
    "complex_sharp": EncoderConfig(quality=30, method=4, filter_sharpness=3),
    "simple": EncoderConfig(quality=60, method=4, filter_type=0,
                            filter_strength=20),
    "none": EncoderConfig(quality=60, method=4, filter_strength=0),
}
SHAPES = [(16, 16), (5, 3), (33, 49), (1, 64), (17, 1)]


def _payload(data: bytes) -> bytes:
    return priff.parse_riff(data).find(b"VP8 ").payload


def _corpus():
    files = [_pillow(s, quality=40 + 10 * i) for i, s in enumerate(SHAPES)]
    return files + [_jax_encoded(c) for c in CONFIGS.values()]


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------

def test_container_parse_matches_jax():
    for data in _corpus() + [_pillow((20, 30), lossless=True)]:
        a, b = priff.parse_riff(data), jriff.parse_riff(data)
        assert [(c.tag, c.payload) for c in a.chunks] == \
            [(c.tag, c.payload) for c in b.chunks]
        vp8 = a.find(b"VP8 ")
        if vp8 is not None:
            assert priff.vp8_dimensions(vp8.payload) == \
                jriff._vp8_dimensions(vp8.payload)
    with pytest.raises(BitstreamError):
        priff.parse_riff(b"RIFF\x04\x00\x00\x00WEBQ")


@pytest.mark.parametrize("engine", ["batch", "single"])
def test_symbols_match_jax(engine):
    payloads = [_payload(d) for d in _corpus()]
    want = jdec.decode_vp8_symbols_batch(payloads)
    got = (pdec.decode_vp8_symbols_batch(payloads) if engine == "batch"
           else [pdec.decode_vp8_symbols(p) for p in payloads])
    assert pdec.symbol_engine() in ("vector", "single-stream")
    for (st, c, m), (jst, jc, jm) in zip(got, want):
        assert (st.width, st.height, st.filter_type) == \
            (jst.width, jst.height, jst.filter_type)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(pdec.vp8_filter_params(st, m),
                                      jdec.vp8_filter_params(jst, jm))


def test_batch_symbols_of_one_long_partition_decoded_alone():
    """One image, one token partition of some 1.7M boolean decisions: the
    batch engine's one busy lane runs while 31 stay parked for more than
    2^20 steps, past the bit budget a parked lane starts with (its refill
    reads must stay off; the hybrid engine's 4096x4096 file ended the
    process there).  Every block codes a non-zero at position 15 behind
    a run of cheap zeros.  Equal to the single-stream decoder."""
    from gowebp_tpu_torch.config import EncoderConfig as PConfig
    from gowebp_tpu_torch.models.vp8.encoder import emit_frame_arrays

    mb = 64
    total = mb * mb
    y2 = np.zeros((total, 16), np.int16)
    yl = np.zeros((total, 16, 16), np.int16)
    uvl = np.zeros((total, 8, 16), np.int16)
    for lv in (y2, yl, uvl):
        lv[..., 15] = 1
    z = np.zeros(total, np.uint8)
    payload = emit_frame_arrays(y2, yl, uvl, z, z, z, mb, mb, 16 * mb,
                                16 * mb, 40, PConfig(lossless=False))
    st, coeffs, modes = pdec.decode_vp8_symbols(payload)
    assert len(st.partition_bytes) == 1
    assert int((coeffs != 0).sum()) == total * 40
    ((bst, bc, bm),) = pdec.decode_vp8_symbols_batch([payload])
    np.testing.assert_array_equal(bc, coeffs)
    np.testing.assert_array_equal(bm, modes)


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def test_residual_blocks_match_jax():
    coeffs = RNG.integers(-2048, 2048, (2, 3, 24, 16)).astype(np.int16)
    coeffs[0, 0, 0, 0] = -32768                  # int32 wrap of the iDCT
    got = precon.residual_blocks(torch.from_numpy(coeffs))
    want = jrecon.residual_blocks(coeffs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _recon_args(payloads):
    recs = [pdec.decode_vp8_symbols(p) for p in payloads]
    st = recs[0][0]
    modes = np.stack([m for _, _, m in recs])
    args = (np.stack([c for _, c, _ in recs]),
            modes[:, :, 0].astype(np.int32),
            modes[:, :, 5:21].astype(np.int32),
            modes[:, :, 1].astype(np.int32),
            np.stack([pdec.vp8_filter_params(s, m) for s, _, m in recs]))
    return st, args


RECON_CASES = ([f"config_{k}" for k in CONFIGS] + ["segments4"]
               + [f"shape_{h}x{w}" for h, w in SHAPES] + ["batch3"])


def _recon_files(case):
    if case.startswith("config_"):
        return [_jax_encoded(CONFIGS[case[7:]])]
    if case == "segments4":
        return [_pillow((48, 64), quality=45, seed=5)]
    if case == "batch3":
        return [_pillow((48, 48), quality=75, seed=s) for s in range(3)]
    h, w = map(int, case[6:].split("x"))
    return [_pillow((h, w))]


@pytest.mark.parametrize("case", RECON_CASES)
def test_recon_frame_matches_jax(case):
    payloads = [_payload(d) for d in _recon_files(case)]
    st, args = _recon_args(payloads)
    if case == "segments4":
        assert st.segment_hdr.update_map
        assert len({tuple(r) for r in st.quant_rows()}) == 4
    if case.startswith("config_"):
        want_type = {"none": 0, "simple": 1}.get(case[7:], 2)
        assert st.filter_type == want_type
    kw = dict(mb_w=st.mb_w, mb_h=st.mb_h, filter_type=st.filter_type)
    want = jrecon.recon_frame(*args, **kw)
    marks = []
    got = precon.recon_frame(*(torch.from_numpy(a) for a in args), **kw,
                             marks=marks.append)
    assert marks == ["idct", "recon", "filter"]
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Fancy upsampling + YUV→RGBA
# ---------------------------------------------------------------------------

def _planes(b, h, w):
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return (RNG.integers(0, 256, (b, h, w)).astype(np.uint8),
            RNG.integers(0, 256, (b, h2, w2)).astype(np.uint8),
            RNG.integers(0, 256, (b, h2, w2)).astype(np.uint8))


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 32, 64), (1, 48, 10),
                                   (2, 5, 3), (1, 1, 1), (1, 1, 8),
                                   (3, 17, 33), (1, 2, 2), (1, 9, 1)])
def test_yuv_to_rgba_matches_xla(shape):
    y, u, v = _planes(*shape)
    want = np.asarray(yuv_jax._batch_yuv_to_rgba_xla(
        y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)))
    got = pyuv.batch_yuv_to_rgba(*(torch.from_numpy(p) for p in (y, u, v)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's wrapper on CPU tensors: MB-padded planes, cropped
    b, h, w = shape
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    yp = np.zeros((b, H, W), np.uint8)
    up = np.zeros((b, H // 2, W // 2), np.uint8)
    vp = np.zeros_like(up)
    yp[:, :h, :w] = y
    up[:, :u.shape[1], :u.shape[2]] = u
    vp[:, :v.shape[1], :v.shape[2]] = v
    before = yuv420_to_rgba.launches
    got = yuv420_to_rgba(*(torch.from_numpy(p) for p in (yp, up, vp)), h, w)
    assert yuv420_to_rgba.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 32, 64), (1, 48, 10)])
def test_yuv_to_rgba_matches_pallas(shape, alpha):
    y, u, v = _planes(*shape)
    a = RNG.integers(0, 256, shape).astype(np.uint8) if alpha else None
    want = np.asarray(yuv420_to_rgba_pallas(
        y.astype(np.int32), u.astype(np.int32), v.astype(np.int32),
        None if a is None else a.astype(np.int32), interpret=True))
    got = yuv420_to_rgba_plain(
        *(torch.from_numpy(p) for p in (y, u, v)), shape[1], shape[2],
        None if a is None else torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv_wrapper_rejects_planes_too_small():
    y, u, v = (torch.from_numpy(p) for p in _planes(1, 16, 16))
    with pytest.raises(ValueError):
        yuv420_to_rgba(y, u, v, 17, 16)
    with pytest.raises(ValueError):
        yuv420_to_rgba(y, u[:, :7], v, 16, 16)


# ---------------------------------------------------------------------------
# The decode path as a whole
# ---------------------------------------------------------------------------

def test_decode_batch_matches_jax():
    """A mixed batch: three frame shapes, repeats, two filter types."""
    datas = [_pillow((33, 49), quality=30 + 10 * s, seed=s) for s in range(3)]
    datas += [_pillow((16, 16), seed=7), _jax_encoded(CONFIGS["simple"]),
              _pillow((16, 16), seed=9)]
    want = gowebp_tpu.decode_rgba_batch(datas, recon_backend="jax")
    got = decode_rgba_batch(datas, device="cpu")
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, np.asarray(w))
    timings = {}
    dev = decode_rgba_batch(datas[:3], device="cpu", device_out=True,
                            threads=2, timings=timings)
    assert all(isinstance(d, torch.Tensor) for d in dev)
    for d, w in zip(dev, want):
        np.testing.assert_array_equal(d.numpy(), np.asarray(w))
    assert set(timings["stage_ms"]) == {"h2d", "unpack", "idct", "recon",
                                        "filter", "yuv420_to_rgba"}


def test_decode_batch_spreads_over_engine_calls():
    """More images than one engine call's lanes: two symbol groups in two
    threads, merged back in input order."""
    datas = [_pillow((16, 16), quality=20 + s, seed=s) for s in range(40)]
    got = decode_rgba_batch(datas, device="cpu", threads=2)
    for s in (0, 1, 38, 39):
        want = np.asarray(Image.open(io.BytesIO(datas[s])).convert("RGBA"))
        np.testing.assert_array_equal(got[s], want)


@pytest.mark.parametrize("kind", ["vp8l", "alpha", "no_image"])
def test_other_files_raise(kind):
    img = _photo((24, 24), seed=4)
    buf = io.BytesIO()
    if kind == "vp8l":
        Image.fromarray(img).save(buf, "WEBP", lossless=True)
    elif kind == "alpha":
        rgba = np.dstack([img, np.full((24, 24), 128, np.uint8)])
        Image.fromarray(rgba).save(buf, "WEBP", quality=80)
    else:
        buf.write(b"RIFF\x0c\x00\x00\x00WEBPJUNK\x00\x00\x00\x00")
    datas = [_pillow((16, 16)), buf.getvalue()]
    if kind == "no_image":
        with pytest.raises(BitstreamError):
            decode_rgba_batch(datas, device="cpu")
        return
    # VP8L and lossy + ALPH files decode to the JAX package's pixels
    want = gowebp_tpu.decode_rgba_batch(datas, recon_backend="jax")
    got = decode_rgba_batch(datas, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
