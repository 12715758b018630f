"""PyTorch port, the single-image lossy encode (``encode_rgba``,
``encode_yuv``, the ALPH encoder) on ``device="cpu"`` against the JAX
package's ``encode_rgba``/``encode_yuv``, bit for bit (tolerance 0: the
codec is integer math), ``EncodeStats`` field for field and exception
class for exception class.

- ``.webp`` bytes over sizes 1x1 to 64x48, qualities 0-100, methods 0-6
  (method 6's trellis pass, and with ``low_memory``), segments, filters,
  ``autofilter``, ``emulate_jpeg_size``, ``preprocessing``,
  ``use_sharp_yuv``, rate control, partitions, ``qmin``/``qmax``, every
  preset; RGB, opaque and non-opaque RGBA with every ALPH option and
  ``exact``; ``plane_backend`` "jax" and "jax-openloop" against the
  reference's same backend (JAX on the CPU; few shapes, to bound its
  compiles); ``encode_yuv`` with and without alpha;
- the progress hook, every ``validate()`` check and bad input, and
  ``lossless=True`` (UnsupportedFeature until the port has the lossless
  encoder);
- the modules: the ALPH encoder and its VP8L stream, the Huffman code
  lengths, and the exact engine's trellis form (``trellis_refine``, and
  ``encode_wavefront_core(trellis=...)`` against the host encoder's
  trellis pass arrays, ``_encode_frame_dense_native(trellis_probs=...)``);
  a numpy model of the kernel's register DP (i4_lanes.cuh
  ``trellis_refine``) against the plain one.
"""

import numpy as np
import pytest
import torch

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.config import EncoderConfig as JConfig
from gowebp_tpu.config import Preset as JPreset
from gowebp_tpu.models.vp8 import encoder as jenc
from gowebp_tpu.stats import EncodeStats as JStats
from gowebp_tpu_torch import EncoderConfig, EncodeStats
from gowebp_tpu_torch.config import Preset
from gowebp_tpu_torch.errors import UnsupportedFeature


def _image(h, w, seed, alpha=None):
    """A seeded photographic-ish RGB image; ``alpha``: None (RGB),
    "opaque" (all 255), "soft" (a ramp with noise and a fully transparent
    corner) or "holes" (0/255 16x16 blocks, some fully transparent)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([120 + 60 * np.sin(xx / 5), 110 + 50 * np.cos(yy / 4),
                    (3 * xx + 2 * yy) % 256], -1)
    rgb = (rgb + rng.normal(0, 14, rgb.shape)).clip(0, 255).astype(np.uint8)
    if alpha is None:
        return rgb
    if alpha == "opaque":
        a = np.full((h, w), 255)
    elif alpha == "soft":
        a = 255 * xx / max(w - 1, 1) + rng.integers(-30, 30, (h, w))
        a[: h // 3, : w // 3] = 0
    else:
        a = np.where(((yy // 16) + (xx // 16)) % 3 == 0, 0, 255)
        a[h // 2:, w // 2:] = rng.integers(0, 256, (h - h // 2, w - w // 2))
    return np.dstack([rgb, a.clip(0, 255).astype(np.uint8)])


def _both(img, stats=True, **kw):
    """The reference's and the port's (device="cpu") bytes and stats."""
    js, ps = (JStats(), EncodeStats()) if stats else (None, None)
    want = gowebp_tpu.encode_rgba(img, config=JConfig(**kw), stats=js)
    got = gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(**kw),
                                       stats=ps, device="cpu")
    return want, got, js, ps


def _assert_same(img, **kw):
    want, got, js, ps = _both(img, **kw)
    assert got == want
    assert vars(ps) == vars(js)


SIZES = [(1, 1), (3, 2), (17, 33), (48, 64)]


@pytest.mark.parametrize("quality", [0, 50, 75, 98, 99, 100])
@pytest.mark.parametrize("h,w", SIZES)
def test_sizes_and_qualities(h, w, quality):
    _assert_same(_image(h, w, seed=h + w + quality), quality=quality)


@pytest.mark.parametrize("method", range(7))
def test_methods(method):
    _assert_same(_image(48, 64, seed=3, alpha="soft"), method=method)


@pytest.mark.parametrize("kw", [
    {"method": 6, "low_memory": True},
    {"method": 6, "quality": 95, "segments": 2},
    {"method": 6, "quality": 20, "partition_limit": 100},
    {"method": 6, "autofilter": True},
    {"method": 5, "low_memory": True, "autofilter": True},
], ids=["low_memory", "q95_seg2", "q20_no_i4", "autofilter", "m5_low_mem"])
def test_method6_trellis_and_low_memory(kw):
    _assert_same(_image(32, 48, seed=9), **kw)


@pytest.mark.parametrize("segments", [1, 2, 4])
@pytest.mark.parametrize("filter_type,sharpness,strength",
                         [(0, 0, 60), (1, 5, 30), (1, 7, 100)])
def test_segments_and_filters(segments, filter_type, sharpness, strength):
    _assert_same(_image(48, 64, seed=segments), segments=segments,
                 filter_type=filter_type, filter_sharpness=sharpness,
                 filter_strength=strength, sns_strength=80)


@pytest.mark.parametrize("kw", [
    {"autofilter": True},
    {"autofilter": True, "low_memory": True},
    {"emulate_jpeg_size": True},
    {"emulate_jpeg_size": True, "quality": 40},
    {"preprocessing": 1},
    {"preprocessing": 2},
    {"use_sharp_yuv": True},
    {"target_size": 700, "passes": 3},
    {"target_size": 100000, "passes": 1},
    {"target_psnr": 33.0, "passes": 5},
    {"partitions": 1},
    {"partitions": 2},
    {"partitions": 3},
    {"qmin": 30, "qmax": 40},
    {"qmin": 90, "qmax": 100, "quality": 10},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_options(kw):
    _assert_same(_image(48, 64, seed=17, alpha="soft"), **kw)


@pytest.mark.parametrize("n,bits,amp", [(1, 14, 128), (200, 14, 256),
                                        (3000, 16, 77)])
def test_dither_stream_is_the_reference_one(n, bits, amp):
    """The preprocessing-2 dither draws are the reference encoder's; they
    equal the decoder's VP8Random draws up to draw 47 and part from them at
    draw 48, where the reference's vector step reads stale table entries."""
    from gowebp_tpu_torch.models.vp8.decoder import VP8Random, _centre
    from gowebp_tpu_torch.models.vp8.encoder import _vp8_random_stream

    got = _vp8_random_stream(n, bits, amp)
    np.testing.assert_array_equal(got, jenc._vp8_random_stream(n, bits, amp))
    vp8 = _centre(VP8Random().raw(n), bits, amp)
    np.testing.assert_array_equal(got[:48], vp8[:48])
    if n > 48:
        assert got[48] != vp8[48]


@pytest.mark.parametrize("preset", list(Preset))
def test_presets(preset):
    img = _image(40, 56, seed=int(preset))
    want = gowebp_tpu.encode_rgba(
        img, config=JConfig.from_preset(JPreset(int(preset)), quality=70.0))
    got = gowebp_tpu_torch.encode_rgba(
        img, config=EncoderConfig.from_preset(preset, quality=70.0),
        device="cpu")
    assert got == want


@pytest.mark.parametrize("alpha", [None, "opaque", "soft", "holes"])
def test_channels_and_alpha(alpha):
    _assert_same(_image(33, 47, seed=5, alpha=alpha))


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("quality", [100, 50])
@pytest.mark.parametrize("filtering", [0, 1, 2])
def test_alph_options(filtering, quality, compression):
    _assert_same(_image(36, 40, seed=7, alpha="soft"),
                 alpha_filtering=filtering, alpha_quality=quality,
                 alpha_compression=compression)


@pytest.mark.parametrize("exact", [False, True])
def test_transparent_blocks_and_exact(exact):
    """Fully transparent 16x16 blocks: their RGB is flattened unless
    ``exact`` (the cleanup), and the alpha survives either way."""
    img = _image(48, 64, seed=11, alpha="holes")
    _assert_same(img, exact=exact)
    data = gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(exact=exact),
                                        device="cpu")
    dec = gowebp_tpu_torch.decode_rgba(data, device="cpu")
    np.testing.assert_array_equal(dec[..., 3], img[..., 3])


@pytest.mark.parametrize("kw", [
    {"plane_backend": "jax"},
    {"plane_backend": "jax", "method": 3, "segments": 1, "quality": 99},
    {"plane_backend": "jax", "autofilter": True, "low_memory": True,
     "emulate_jpeg_size": True, "preprocessing": 1},
    {"plane_backend": "jax-openloop"},
    {"plane_backend": "jax-openloop", "quality": 30, "partitions": 2},
], ids=["jax", "jax_m3_q99", "jax_autofilter_low_memory", "openloop",
        "openloop_q30"])
def test_plane_backends(kw):
    """The reference's device backends' bytes (JAX on the CPU) on one
    shape, and the same statistics (which those backends fill only in
    part)."""
    _assert_same(_image(48, 64, seed=21, alpha="soft"), **kw)


def test_encode_yuv():
    rng = np.random.default_rng(8)
    y = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    u = rng.integers(0, 256, (17, 24), dtype=np.uint8)
    v = rng.integers(0, 256, (17, 24), dtype=np.uint8)
    a = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    for kw in ({}, {"alpha": a}, {"alpha": a, "method": 6, "quality": 60}):
        js, ps = JStats(), EncodeStats()
        want = gowebp_tpu.encode_yuv(y, u, v, stats=js, **kw)
        got = gowebp_tpu_torch.encode_yuv(y, u, v, stats=ps, device="cpu",
                                          **kw)
        assert got == want
        assert vars(ps) == vars(js)


def test_progress_hook_calls_and_abort():
    img = _image(16, 16, seed=1)
    seen = {"ref": [], "port": []}
    gowebp_tpu.encode_rgba(img, config=JConfig(
        progress_hook=lambda p: seen["ref"].append(p)))
    gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(
        progress_hook=lambda p: seen["port"].append(p)), device="cpu")
    assert seen["port"] == seen["ref"] == [0, 100]
    for stop_at in (0, 100):
        for mod, cfg in ((gowebp_tpu, JConfig), (gowebp_tpu_torch,
                                                 EncoderConfig)):
            hook = lambda p, s=stop_at: p != s  # noqa: E731
            kw = {} if mod is gowebp_tpu else {"device": "cpu"}
            with pytest.raises(mod.EncodeError, match="aborted"):
                mod.encode_rgba(img, config=cfg(progress_hook=hook), **kw)
            y = np.zeros((4, 4), np.uint8)
            u = np.zeros((2, 2), np.uint8)
            with pytest.raises(mod.EncodeError, match="aborted"):
                mod.encode_yuv(y, u, u, config=cfg(progress_hook=hook), **kw)


BAD_CONFIGS = [
    {"quality": 101}, {"quality": -1}, {"method": 7}, {"method": -1},
    {"segments": 0}, {"segments": 5}, {"sns_strength": 101},
    {"filter_strength": -1}, {"filter_sharpness": 8}, {"filter_type": 2},
    {"alpha_compression": 2}, {"alpha_filtering": 3},
    {"alpha_quality": 101}, {"passes": 0}, {"passes": 11},
    {"preprocessing": 3}, {"partitions": 4}, {"partition_limit": 101},
    {"near_lossless": 101}, {"target_size": -1}, {"target_psnr": -1.0},
    {"qmin": 60, "qmax": 50}, {"qmax": 101},
]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_validate_checks_raise_the_same_class(kw):
    img = _image(8, 8, seed=2)
    with pytest.raises(gowebp_tpu.InvalidConfig) as want:
        gowebp_tpu.encode_rgba(img, config=JConfig(**kw))
    with pytest.raises(gowebp_tpu_torch.InvalidConfig) as got:
        gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(**kw),
                                     device="cpu")
    assert str(got.value) == str(want.value)
    y, u = np.zeros((4, 4), np.uint8), np.zeros((2, 2), np.uint8)
    with pytest.raises(gowebp_tpu_torch.InvalidConfig):
        gowebp_tpu_torch.encode_yuv(y, u, u, config=EncoderConfig(**kw),
                                    device="cpu")


BAD_RGBA = {
    "float32": np.zeros((8, 8, 3), np.float32),
    "two_dims": np.zeros((8, 8), np.uint8),
    "five_channels": np.zeros((8, 8, 5), np.uint8),
    "two_channels": np.zeros((8, 8, 2), np.uint8),
}


@pytest.mark.parametrize("name", list(BAD_RGBA))
def test_bad_rgba_raises_the_same_class(name):
    arr = BAD_RGBA[name]
    with pytest.raises(gowebp_tpu.EncodeError):
        gowebp_tpu.encode_rgba(arr)
    with pytest.raises(gowebp_tpu_torch.EncodeError):
        gowebp_tpu_torch.encode_rgba(arr, device="cpu")


BAD_YUV = {
    "u_shape": ((9, 9), (4, 5), (5, 5), None),
    "v_shape": ((9, 9), (5, 5), (5, 4), None),
    "alpha_shape": ((9, 9), (5, 5), (5, 5), (9, 8)),
    "int16": ((9, 9), (5, 5), (5, 5), None),
}


@pytest.mark.parametrize("name", list(BAD_YUV))
def test_bad_yuv_raises_the_same_class(name):
    ys, us, vs, as_ = BAD_YUV[name]
    dt = np.int16 if name == "int16" else np.uint8
    y, u, v = np.zeros(ys, dt), np.zeros(us, np.uint8), np.zeros(vs, np.uint8)
    kw = {} if as_ is None else {"alpha": np.zeros(as_, np.uint8)}
    with pytest.raises(gowebp_tpu.EncodeError):
        gowebp_tpu.encode_yuv(y, u, v, **kw)
    with pytest.raises(gowebp_tpu_torch.EncodeError):
        gowebp_tpu_torch.encode_yuv(y, u, v, device="cpu", **kw)


@pytest.mark.parametrize("how", ["argument", "config"])
def test_lossless_raises_unsupported(how):
    img = _image(8, 8, seed=3)
    kw = ({"lossless": True} if how == "argument"
          else {"config": EncoderConfig(lossless=True)})
    with pytest.raises(UnsupportedFeature, match="Queue 1 item 3"):
        gowebp_tpu_torch.encode_rgba(img, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _planes():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:70, 0:90]
    return {
        "random": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "flat": np.full((40, 50), 200, np.uint8),
        "gradient": ((xx * 3 + yy) % 256).astype(np.uint8),
        "row": rng.integers(0, 256, (1, 77)).astype(np.uint8),
        "column": rng.integers(0, 3, (65, 1)).astype(np.uint8) * 90,
        "blocks": np.where((yy // 8 + xx // 8) % 2, 255, 0).astype(np.uint8),
    }


@pytest.mark.parametrize("name", list(_planes()))
def test_alpha_encoder_bytes(name):
    from gowebp_tpu.models.vp8.alpha import _filter as j_filter
    from gowebp_tpu.models.vp8.alpha import encode_alpha as j_alpha
    from gowebp_tpu.models.vp8l.encoder import encode_vp8l_alpha as j_vp8l
    from gowebp_tpu_torch.models.vp8.alpha import (_filter, _unfilter,
                                                   decode_alpha, encode_alpha)
    from gowebp_tpu_torch.models.vp8l.encoder import encode_vp8l_alpha

    plane = _planes()[name]
    assert encode_vp8l_alpha(plane) == j_vp8l(plane)
    for kw in ({}, {"filtering_level": 2}, {"method": 0, "filtering_level": 2},
               {"quality": 40}, {"filtering_level": 0}):
        data = encode_alpha(plane, **kw)
        assert data == j_alpha(plane, **kw), kw
        if kw.get("quality", 100) == 100:
            h, w = plane.shape
            np.testing.assert_array_equal(decode_alpha(data, w, h), plane)
    for fm in range(4):
        filtered = _filter(fm, plane)
        np.testing.assert_array_equal(filtered, j_filter(fm, plane))
        np.testing.assert_array_equal(_unfilter(fm, filtered), plane)


@pytest.mark.parametrize("seed", range(4))
def test_build_code_lengths(seed):
    from gowebp_tpu.entropy.huffman import build_code_lengths as j_build
    from gowebp_tpu.entropy.huffman import canonical_codes as j_codes
    from gowebp_tpu_torch.entropy.huffman import (build_code_lengths,
                                                  canonical_codes)

    rng = np.random.default_rng(seed)
    n = [19, 256, 280, 40][seed]
    hist = (rng.pareto(0.7, n) * 5).astype(np.int64) * (rng.random(n) < 0.7)
    for h, depth in ((hist, 15), (hist[:19], 7), (np.eye(1, n, 3)[0] * 9, 15),
                     (np.zeros(n, np.int64), 15)):
        got = build_code_lengths(h, max_depth=depth)
        np.testing.assert_array_equal(got, j_build(h, max_depth=depth))
        np.testing.assert_array_equal(canonical_codes(got), j_codes(got))


def _frame_case(mh, mw, seed):
    rng = np.random.default_rng(seed)
    H, W = 16 * mh, 16 * mw
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    y[: H // 2] = np.clip(y[: H // 2] // 8 + 100, 0, 255)   # some flat MBs
    u = rng.integers(90, 170, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    base = jenc.quality_to_q(60.0)
    deltas = [-9, -3, 4, 10]
    quants = [jenc.make_quants(base + d) for d in deltas]
    seg = {"map": rng.integers(0, 4, mh * mw).astype(np.uint8),
           "deltas": deltas, "quants": quants, "probs": [128, 128, 128]}
    return y, u, v, seg, jenc.make_quants(base)


def _host_trellis_recon(y, u, v, mw, mh, seg, rows, pens, tables, lams):
    """The reference's native trellis pass (``_encode_frame_dense_native``
    with ``trellis_probs``, as called there) with its recon planes, which
    that wrapper does not return."""
    import ctypes

    from gowebp_tpu.entropy.native_loader import get_lib

    n = mw * mh
    outs = [np.zeros((n, 16), np.int16), np.zeros((n, 16, 16), np.int16),
            np.zeros((n, 8, 16), np.int16)] + [np.zeros(n, np.uint8)
                                               for _ in range(3)]
    outs += [np.zeros((n, 16), np.uint8), np.zeros_like(y), np.zeros_like(u),
             np.zeros_like(v)]

    def p(a, t):
        return np.ascontiguousarray(a).ctypes.data_as(ctypes.POINTER(t))

    tp = [np.ascontiguousarray(t, np.uint16) for t in tables]
    get_lib().wtpu_vp8_encode_frame(
        p(y, ctypes.c_uint8), p(u, ctypes.c_uint8), p(v, ctypes.c_uint8),
        mw, mh, p(rows, ctypes.c_int32), 1, p(pens, ctypes.c_int32), 1,
        p(seg["map"], ctypes.c_uint8), *(p(t, ctypes.c_uint16) for t in tp),
        p(lams, ctypes.c_int32),
        *(p(o, ctypes.c_int16) for o in outs[:3]),
        *(p(o, ctypes.c_uint8) for o in outs[3:]))
    return outs[-3:]


@pytest.mark.parametrize("mh,mw", [(1, 1), (3, 5), (5, 3)])
def test_trellis_form_matches_the_host_trellis_pass(mh, mw):
    """``encode_wavefront_core(trellis=...)`` (the plain version of the
    full-search kernel's trellis form) gives the host encoder's trellis
    pass arrays: levels, modes, i4 adoption and B-modes, and recon, 4
    segments with their lambdas, tables of the first pass's adapted
    probabilities."""
    from gowebp_tpu.models.vp8.cost import trellis_cost_tables as j_tables
    from gowebp_tpu_torch.models.vp8.cost import trellis_cost_tables
    from gowebp_tpu_torch.ops.encode_wavefront import encode_wavefront_core

    y, u, v, seg, q0 = _frame_case(mh, mw, seed=mh * 10 + mw)
    first = jenc._encode_frame_dense_native(y, u, v, mw, mh, q0, 6, seg=seg,
                                            use_derr=1)
    st = jenc._native_tokenizer_arrays(first["y2"], first["yl"], first["uvl"],
                                       first["is_i4"], mw, mh)
    probs, _ = jenc.finalize_probas(st["stats"])
    want = jenc._encode_frame_dense_native(y, u, v, mw, mh, q0, 6, seg=seg,
                                           trellis_probs=probs, use_derr=1)
    rows = np.array([[s.y1_dc.q, s.y1_ac.q, s.y2_dc.q, s.y2_ac.q, s.uv_dc.q,
                      s.uv_ac.q] for s in seg["quants"]], np.int32)
    _, pens = jenc._i4_config_seg(rows, 6, 0)
    lams = np.array([max(1, (s.y1_ac.q ** 2) >> 10) for s in seg["quants"]],
                    np.int32)
    tables = trellis_cost_tables(probs)
    for a, b in zip(tables, j_tables(probs)):
        np.testing.assert_array_equal(a, b)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))[None]

    got = encode_wavefront_core(
        t(y), t(u), t(v), t(seg["map"].astype(np.int32).reshape(mh, mw)),
        t(rows), tuple(torch.from_numpy(x.astype(np.int32)) for x in tables),
        try_i4=True, i4_penalty=t(pens), use_derr=True, trellis=t(lams),
        want_recon=True)
    for k, kw in (("y_levels", "yl"), ("y2_levels", "y2"),
                  ("uv_levels", "uvl"), ("ymode", "ymode"),
                  ("uvmode", "uvmode"), ("is_i4", "is_i4"),
                  ("imodes", "imodes")):
        np.testing.assert_array_equal(
            got[k][0].numpy().reshape(want[kw].shape), want[kw], err_msg=k)
    recon = _host_trellis_recon(y, u, v, mw, mh, seg, rows, pens,
                                j_tables(probs), lams)
    for k, plane in zip(("recon_y", "recon_u", "recon_v"), recon):
        np.testing.assert_array_equal(got[k][0].numpy(), plane, err_msg=k)
    assert not np.array_equal(first["yl"], want["yl"])   # the trellis acted


def kernel_dp_model(lv, cf, first, dc_q, ac_q, lam, p0, p1, val):
    """i4_lanes.cuh ``trellis_refine<kFirst>`` transliterated to Python
    ints: two states in registers, a choice bit per position and
    candidate, the backtrack from the bits; zigzag levels ``lv`` (16,),
    raster coefficients ``cf`` (16,), per-position tables."""
    from gowebp_tpu_torch.ops.dct import _ZIGZAG

    inf = 1 << 60
    lv = [int(x) for x in lv]
    s0, s1, c0, c1, a0, a1, nxt = 0, inf, 1, 1, 0, 0, first
    m0 = m1 = 0
    for n in range(first, 16):
        v = abs(lv[n])
        after = nxt == n
        r0, r1 = 3 * n + (c0 if after else 0), 3 * n + (c1 if after else 0)
        if after:
            a0, a1 = p0[r0][1], p0[r1][1]
        if v == 0:
            a0 += p1[r0][0]
            a1 += p1[r1][0]
            continue
        araw = abs(int(cf[_ZIGZAG[n]]))
        qs = dc_q if n == 0 else ac_q
        b0 = s0 + (a0 + p1[r0][1] + 256) * lam
        b1 = s1 + (a1 + p1[r1][1] + 256) * lam
        ns, pick = [0, 0], [0, 0]
        for c in range(2):
            w = v - c
            e = araw - w * qs
            t0 = b0 + val[r0][min(w, 67)] * lam + e * e
            t1 = inf if s1 >= inf else b1 + val[r1][min(w, 67)] * lam + e * e
            pick[c] = int(t1 < t0)
            ns[c] = inf if (c == 1 and w < 1) else (t1 if pick[c] else t0)
        m0 |= pick[0] << n
        m1 |= pick[1] << n
        s0, s1 = ns
        c0, c1 = (1 if v == 1 else 2), (1 if v - 1 == 1 else 2)
        nxt = n + 1
    if nxt <= 15:
        s0 += p0[3 * nxt + c0][0] * lam
        if s1 < inf:
            s1 += p0[3 * nxt + c1][0] * lam
    cur = int(s1 < s0)
    for n in range(15, first - 1, -1):
        if lv[n] == 0:
            continue
        w = abs(lv[n]) - cur
        lv[n] = -w if lv[n] < 0 else w
        cur = ((m1 if cur else m0) >> n) & 1
    return lv


@pytest.mark.parametrize("type_,first", [(0, 1), (1, 0), (2, 0), (3, 0)])
def test_kernel_trellis_dp_model_equals_the_plain_trellis(type_, first):
    """The kernel's register DP (modelled in Python) refines levels as the
    plain ``trellis_refine`` does, on random blocks: sparse and dense,
    levels from 1 to past the 67 clamp, both signs, lambdas 1-60."""
    from gowebp_tpu_torch.models.vp8.encoder import _default_cost_tables
    from gowebp_tpu_torch.ops.dct import BIAS, quantize
    from gowebp_tpu_torch.ops.rate import position_tables, trellis_refine

    rng = np.random.default_rng(type_ * 7 + first)
    probs = np.clip(jenc.COEFF_PROBAS.astype(np.int64)
                    + rng.integers(-50, 51, jenc.COEFF_PROBAS.shape), 1, 255)
    from gowebp_tpu_torch.models.vp8.cost import trellis_cost_tables

    tabs = position_tables(tuple(torch.from_numpy(t.astype(np.int32)) for t in
                                 trellis_cost_tables(probs.astype(np.uint8))),
                           type_)
    assert _default_cost_tables() is not None
    R = 300
    scale = rng.choice([8, 60, 400, 3000], R)[:, None]
    cf = (rng.normal(0, 1, (R, 16)) * scale).astype(np.int64)
    cf[rng.random((R, 16)) < 0.5] = 0
    dc_q = rng.integers(4, 160, R)
    ac_q = rng.integers(4, 160, R)
    lam = rng.integers(1, 61, R)
    lv = quantize(torch.from_numpy(cf.astype(np.int32)).reshape(R, 4, 4),
                  torch.from_numpy(((1 << 17) // dc_q).astype(np.int32)),
                  BIAS["y1_dc"],
                  torch.from_numpy(((1 << 17) // ac_q).astype(np.int32)),
                  BIAS["y1_ac"], first_ac=first == 1)
    got = trellis_refine(lv, torch.from_numpy(cf), *tabs, first=first,
                         ctx0=1, dc_q=torch.from_numpy(dc_q),
                         ac_q=torch.from_numpy(ac_q), lam=torch.from_numpy(lam))
    p0, p1, val = (t.reshape(48, -1).tolist() for t in tabs)
    changed = 0
    for r in range(R):
        want = kernel_dp_model(lv[r].tolist(), cf[r], first, int(dc_q[r]),
                               int(ac_q[r]), int(lam[r]), p0, p1, val)
        assert got[r].tolist() == want, r
        changed += want != lv[r].tolist()
    assert changed > 10                              # the trellis acted
