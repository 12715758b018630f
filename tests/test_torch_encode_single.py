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
- the progress hook, every ``validate()`` check and bad input, and both
  spellings of ``lossless=True`` (the reference's bytes; the lossless
  encode's own cases are in tests/test_torch_lossless.py);
- the modules: the ALPH encoder and its VP8L stream, the Huffman code
  lengths, and the exact engine's trellis form (``trellis_refine``, and
  ``encode_wavefront_core(trellis=...)`` against the host encoder's
  trellis pass arrays, ``_encode_frame_dense_native(trellis_probs=...)``);
  Python models of the serial register DP and of the kernel's lane scan
  (i4_lanes.cuh ``trellis_lanes``) against each other and the plain one,
  on random blocks, forced ties and edge blocks.
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
    """Neither spelling of a lossless encode raises UnsupportedFeature:
    ``lossless=True`` and ``config=EncoderConfig(lossless=True)`` both
    give the reference's VP8L bytes and statistics."""
    img = _image(8, 8, seed=3)
    kw = ({"lossless": True} if how == "argument"
          else {"config": EncoderConfig(lossless=True)})
    jkw = ({"lossless": True} if how == "argument"
           else {"config": JConfig(lossless=True)})
    js, ps = JStats(), EncodeStats()
    want = gowebp_tpu.encode_rgba(img, stats=js, **jkw)
    got = gowebp_tpu_torch.encode_rgba(img, device="cpu", stats=ps, **kw)
    assert got == want and got[12:16] == b"VP8L"
    assert vars(ps) == vars(js)


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


def kernel_dp_model(lv, cf, first, dc_q, ac_q, lam, p0, p1, val, ties=None):
    """The serial one-lane trellis DP (the host encoder's form, which
    ``trellis_lanes``' model below is held to) transliterated to Python
    ints: two states in registers, a choice bit per position and
    candidate, the backtrack from the bits; zigzag levels ``lv`` (16,),
    raster coefficients ``cf`` (16,), per-position tables.  ``ties``, a
    list, gets (n, c) for each choice between two equal finite costs."""
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
            if ties is not None and t1 == t0 < inf and w >= 1:
                ties.append((n, c))
        m0 |= pick[0] << n
        m1 |= pick[1] << n
        s0, s1 = ns
        c0, c1 = (1 if v == 1 else 2), (1 if v - 1 == 1 else 2)
        nxt = n + 1
    if nxt <= 15:
        s0 += p0[3 * nxt + c0][0] * lam
        if s1 < inf:
            s1 += p0[3 * nxt + c1][0] * lam
    if ties is not None and s1 == s0 < inf:
        ties.append((16, 0))
    cur = int(s1 < s0)
    for n in range(15, first - 1, -1):
        if lv[n] == 0:
            continue
        w = abs(lv[n]) - cur
        lv[n] = -w if lv[n] < 0 else w
        cur = ((m1 if cur else m0) >> n) & 1
    return lv


LANES_INF = 1 << 58          # i4_lanes.cuh kTrellisInf
FINITE_BOUND = 1 << 55       # the bound on finite scores its comment argues


def nth_bit(mask, i):
    """The position of the i-th set bit of a 16-bit mask, by halves, as
    i4_lanes.cuh ``trellis_lanes`` finds it (15 past the mask)."""
    n = 0
    for w in (8, 4, 2, 1):
        c = bin(mask & ((1 << w) - 1)).count("1")
        if i >= c:
            i, n, mask = i - c, n + w, mask >> w
    return 0 if i < 0 else n & 15


def trellis_state(p0, p1, fin, i, kb):
    """The state (1: lowered) at rank i of a block of kb non-zeros from its
    choice masks and final state, as i4_lanes.cuh ``trellis_lanes`` finds
    it: the lowest constant choice above i (or the final state), flipped by
    each negating choice between."""
    above = ((1 << kb) - 1) & ~((2 << i) - 1)
    cst, neg = ~(p0 ^ p1) & above, p0 & ~p1 & above
    cp = (cst & -cst).bit_length() - 1 if cst else kb
    frm = (p0 >> cp) & 1 if cst else fin
    return (frm ^ bin(neg & ((1 << cp) - 1)).count("1")) & 1


def lanes_dp_model(lv, cf, types, lam, tables, seen=None):
    """i4_lanes.cuh ``trellis_lanes`` on one 16-lane segment holding N
    blocks, its lanes as lists: ``lv``/``cf`` (N, 16) raster levels and
    coefficients (lane k holds raster entry k of each block); ``types``
    N (table, first, dc_q, ac_q); ``tables`` per table index the
    per-position (p0, p1, val) as 48-row lists.  Mirrors the kernel step by
    step: each block's non-zero mask (a ballot of position k's level,
    fetched by shuffle), the greedy packing into rounds of 16 lanes, and in
    each round each lane's non-zero (rank i of block bj: the i-th set bit
    of its mask, found by halves), its level and coefficient by shuffle,
    its predecessor's position and level by a shuffle up, its 2x2 min-plus
    matrix, the
    segmented Kogge-Stone scan (shuffle-up steps while d < the round's
    largest count), the predecessor's scores (s0, s1) by a shuffle up, the
    choice ballots ((M[1][c] - M[0][c]) < s0 - s1, the difference an int
    times lambda), the end-of-block ballot on each block's last non-zero,
    each lane's state in bit-parallel form (``trellis_state``) and its
    ballot; then raster lane k lowers its levels.  (The kernel runs two
    rounds side by side and scans both while d is below the larger count;
    a lane's result does not change.)  Every int64 value is checked to stay in
    [0, 2^63) and every finite one below FINITE_BOUND (the kernel needs no
    saturation).  Returns (the refined (N, 16) raster levels, the rounds).
    ``seen``, a list, gets the largest finite score."""
    from gowebp_tpu_torch.ops.dct import _INV_ZIGZAG, _ZIGZAG

    INF, LIM = LANES_INF, 1 << 63
    N, lanes = len(lv), range(16)
    finite = [0]

    def checked(x):
        assert 0 <= x < LIM, x
        if x < INF:
            assert x < FINITE_BOUND, x
            finite[0] = max(finite[0], x)
        return x

    def minplus(a, b):                                      # a then b
        return tuple(checked(min(a[2 * r] + b[c], a[2 * r + 1] + b[2 + c]))
                     for r in range(2) for c in range(2))

    def ballot(bits):
        return sum(1 << n for n in lanes if bits[n])

    def shfl_up(vals, d):                                   # width 16
        return [vals[n - d] if n >= d else vals[n] for n in lanes]

    lam = int(lam)
    lv = [[int(x) for x in row] for row in lv]
    cf = [[int(x) for x in row] for row in cf]
    nz = [ballot([lv[b][_ZIGZAG[k]] != 0 and k >= types[b][1] for k in lanes])
          for b in range(N)]
    cnt = [bin(m).count("1") for m in nz]
    rnd, off, rounds, used = [], [], 1, 0
    for b in range(N):
        if used + cnt[b] > 16:
            rounds, used = rounds + 1, 0
        rnd.append(rounds - 1)
        off.append(used)
        used += cnt[b]
    st = [0] * N
    for r in range(rounds):
        bj, i = [-1] * 16, [0] * 16
        for k in lanes:
            for b in range(N):
                if rnd[b] == r and off[b] <= k < off[b] + cnt[b]:
                    bj[k], i[k] = b, k - off[b]
        kmax = max([1] + [cnt[b] for b in range(N) if rnd[b] == r])
        on = [b >= 0 for b in bj]
        n = [nth_bit(nz[bj[k]] if on[k] else 0, i[k]) for k in lanes]
        w, ac = ([abs(t[bj[k]][_ZIGZAG[n[k]]]) if on[k] else 0
                  for k in lanes] for t in (lv, cf))
        pn, pw = shfl_up(n, 1), shfl_up(w, 1)
        mat, g = [], []
        for k in lanes:
            tab, first, dc_q, ac_q = types[bj[k] if on[k] else 0]
            p0, p1, val = tables[tab]
            pp = lambda row: (p0[row][0], p0[row][1], p1[row][0], p1[row][1])
            z = [sum(p1[3 * m][0] for m in range(x)) for x in lanes]
            nk = n[k]
            p = first - 1 if i[k] == 0 else pn[k]
            ctx0 = 1 if i[k] == 0 or pw[k] == 1 else 2
            ctx1 = 1 if i[k] == 0 or pw[k] == 2 else 2
            adj = nk == p + 1
            q0, q1, rn = pp(3 * (p + 1) + ctx0), pp(3 * (p + 1) + ctx1), pp(3 * nk)
            run = z[nk] - z[min(p + 2, 15)]
            base0 = q0[1] + (q0[3] if adj else q0[2] + run + rn[3]) + 256
            base1 = q1[1] + (q1[3] if adj else q1[2] + run + rn[3]) + 256
            r0, r1 = 3 * nk + (ctx0 if adj else 0), 3 * nk + (ctx1 if adj else 0)
            h0, h1 = min(w[k], 67), min(max(w[k] - 1, 0), 67)
            qs = dc_q if nk == 0 else ac_q
            d0 = (ac[k] - w[k] * qs) ** 2
            d1 = (ac[k] - (w[k] - 1) * qs) ** 2
            u = (base0 + val[r0][h0], base0 + val[r0][h1],
                 base1 + val[r1][h0], base1 + val[r1][h1])
            if on[k]:
                m = (u[0] * lam + d0, u[1] * lam + d1 if w[k] > 1 else INF,
                     u[2] * lam + d0, u[3] * lam + d1 if w[k] > 1 else INF)
            else:
                m = (0, INF, INF, 0)
            mat.append(tuple(checked(x) for x in m))
            g.append((u[2] - u[0], u[3] - u[1]))
        d = 1
        while d < kmax:
            up = shfl_up(mat, d)
            mat = [minplus(up[k], mat[k]) if i[k] >= d else mat[k]
                   for k in lanes]
            d *= 2
        prev = shfl_up([m[:2] for m in mat], 1)
        prev = [(0, INF) if i[k] == 0 else prev[k] for k in lanes]
        pick = [ballot([on[k] and g[k][c] * lam < prev[k][0] - prev[k][1]
                        for k in lanes]) for c in (0, 1)]
        fin = []
        for k in lanes:
            p0 = tables[types[bj[k] if on[k] else 0][0]][0]
            e = 3 * min(n[k] + 1, 15)
            f0 = mat[k][0] + (p0[e + (1 if w[k] == 1 else 2)][0] * lam
                              if n[k] < 15 else 0)
            f1 = mat[k][1] + (p0[e + (1 if w[k] == 2 else 2)][0] * lam
                              if n[k] < 15 else 0)
            fin.append(on[k] and i[k] == cnt[bj[k]] - 1
                       and checked(f1) < checked(f0))
        fin = ballot(fin)
        low = []
        for k in lanes:
            kb = cnt[bj[k]] if on[k] else 0
            oj = off[bj[k]] if on[k] else 0
            p0, p1 = ((x >> oj) & ((1 << kb) - 1) for x in pick)
            last = (fin >> (oj + kb - 1)) & 1 if kb else 0
            low.append(on[k] and trellis_state(p0, p1, last, i[k], kb))
        low = ballot(low)
        for b in range(N):
            if rnd[b] == r:
                st[b] = (low >> off[b]) & ((1 << cnt[b]) - 1)
    out = [row[:] for row in lv]
    for k in lanes:
        pos = _INV_ZIGZAG[k]
        for b in range(N):
            rank = bin(nz[b] & ((1 << pos) - 1)).count("1")
            down = (nz[b] >> pos) & (st[b] >> rank) & 1
            out[b][k] += down if out[b][k] < 0 else -down
    if seen is not None:
        seen.append(finite[0])
    return out, rounds


def _perturbed_tables(rng, type_):
    """Per-position tables of one token type of perturbed probabilities
    (as a first pass's adapted ones are): torch (p0, p1, val)."""
    from gowebp_tpu_torch.models.vp8.cost import trellis_cost_tables
    from gowebp_tpu_torch.ops.rate import position_tables

    probs = np.clip(jenc.COEFF_PROBAS.astype(np.int64)
                    + rng.integers(-50, 51, jenc.COEFF_PROBAS.shape), 1, 255)
    return position_tables(tuple(torch.from_numpy(t.astype(np.int32)) for t in
                                 trellis_cost_tables(probs.astype(np.uint8))),
                           type_)


def _random_trellis_blocks(rng, first, R):
    """R random blocks: raster coefficients, sparse and dense, of scales
    8 to 3000 (levels 1 to past the 67 clamp, both signs), their quantized
    zigzag levels, steps 4-159 and lambdas 1-60."""
    from gowebp_tpu_torch.ops.dct import BIAS, quantize

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
    return lv, cf, dc_q, ac_q, lam


@pytest.mark.parametrize("type_,first", [(0, 1), (1, 0), (2, 0), (3, 0)])
def test_kernel_trellis_dp_model_equals_the_plain_trellis(type_, first):
    """The serial register DP (modelled in Python) refines levels as the
    plain ``trellis_refine`` does, on random blocks: sparse and dense,
    levels from 1 to past the 67 clamp, both signs, lambdas 1-60."""
    from gowebp_tpu_torch.models.vp8.encoder import _default_cost_tables
    from gowebp_tpu_torch.ops.rate import trellis_refine

    rng = np.random.default_rng(type_ * 7 + first)
    tabs = _perturbed_tables(rng, type_)
    assert _default_cost_tables() is not None
    R = 300
    lv, cf, dc_q, ac_q, lam = _random_trellis_blocks(rng, first, R)
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


def _hold_lanes_model(tabs, lv, cf, dc_q, ac_q, lam, first, group=5):
    """Blocks of one token type, ``group`` at a time on one segment (each
    group sharing its first block's steps and lambda, as the kernel's
    calls do), through ``lanes_dp_model``, ``kernel_dp_model`` and the
    plain ``trellis_refine``: all equal.  ``lv`` (R, 16) zigzag levels,
    ``cf`` (R, 16) raster coefficients.  Returns (blocks changed, ties met
    by the serial DP, the largest finite score, the most rounds a group
    took)."""
    from gowebp_tpu_torch.ops.dct import _INV_ZIGZAG, _ZIGZAG
    from gowebp_tpu_torch.ops.rate import trellis_refine

    R = len(lv)
    lv = np.asarray(lv, np.int64).reshape(R, 16)
    cf = np.asarray(cf, np.int64).reshape(R, 16)
    lead = np.arange(R) // group * group
    dc_q, ac_q, lam = (np.broadcast_to(np.asarray(x, np.int64), (R,))[lead]
                       for x in (dc_q, ac_q, lam))
    plain = trellis_refine(torch.from_numpy(lv.astype(np.int32)),
                           torch.from_numpy(cf), *tabs, first=first,
                           ctx0=1, dc_q=torch.from_numpy(dc_q),
                           ac_q=torch.from_numpy(ac_q),
                           lam=torch.from_numpy(lam))
    table = [t.reshape(48, -1).tolist() for t in tabs]
    changed, ties, seen, rounds = 0, [], [], 1
    for g0 in range(0, R, group):
        rows = range(g0, min(R, g0 + group))
        raster = [[lv[r][_INV_ZIGZAG[k]] for k in range(16)] for r in rows]
        types = [(0, first, int(dc_q[g0]), int(ac_q[g0]))] * len(rows)
        got, nr = lanes_dp_model(raster, [cf[r] for r in rows], types,
                                 lam[g0], [table], seen=seen)
        rounds = max(rounds, nr)
        for r, out in zip(rows, got):
            serial = kernel_dp_model(lv[r], cf[r], first, int(dc_q[g0]),
                                     int(ac_q[g0]), int(lam[g0]), *table,
                                     ties=ties)
            assert [out[_ZIGZAG[n]] for n in range(16)] == serial, r
            assert plain[r].tolist() == serial, r
            changed += serial != lv[r].tolist()
    return changed, len(ties), max(seen), rounds


@pytest.mark.parametrize("type_,first", [(0, 1), (1, 0), (2, 0), (3, 0)])
def test_lanes_trellis_model_equals_the_serial_and_plain(type_, first):
    """``trellis_lanes``' scan (modelled lane by lane) refines random
    blocks as the serial DP and the plain ``trellis_refine`` do."""
    rng = np.random.default_rng(type_ * 11 + first + 100)
    tabs = _perturbed_tables(rng, type_)
    lv, cf, dc_q, ac_q, lam = _random_trellis_blocks(rng, first, 200)
    changed, _, _, _ = _hold_lanes_model(tabs, lv, cf, dc_q, ac_q, lam, first)
    assert changed > 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lanes_trellis_model_on_the_i16_hook_mix(seed):
    """The i16 hook's call: 4 AC blocks (type 0, from position 1, the Y1
    steps) and the Y2 block (type 1, from 0, its own steps) packed on one
    segment, one lambda: each block refined as the serial DP and the plain
    trellis refine it with its own type; chroma's 4 blocks of type 2."""
    from gowebp_tpu_torch.ops.dct import _INV_ZIGZAG, _ZIGZAG
    from gowebp_tpu_torch.ops.rate import trellis_refine

    rng = np.random.default_rng(seed + 40)
    tabs = [_perturbed_tables(rng, t) for t in (0, 1, 2)]
    table = [[t.reshape(48, -1).tolist() for t in tab] for tab in tabs]
    rounds, changed = 1, 0
    for _ in range(40):
        lam = int(rng.integers(1, 61))
        y1, y2 = rng.integers(4, 120, 2), rng.integers(8, 200, 2)
        ac_lv, ac_cf, *_ = _random_trellis_blocks(rng, 1, 4)
        y2_lv, y2_cf, *_ = _random_trellis_blocks(rng, 0, 1)
        uv_lv, uv_cf, *_ = _random_trellis_blocks(rng, 0, 4)
        for lv, cf, types in (
                (np.concatenate([ac_lv, y2_lv]), np.concatenate([ac_cf, y2_cf]),
                 [(0, 1, *y1)] * 4 + [(1, 0, *y2)]),
                (uv_lv.numpy(), uv_cf, [(2, 0, *y1)] * 4)):
            lv = np.asarray(lv, np.int64)
            raster = [[row[_INV_ZIGZAG[k]] for k in range(16)] for row in lv]
            got, nr = lanes_dp_model(raster, cf, [(t, f, int(a), int(b)) for
                                                  t, f, a, b in types], lam,
                                     table)
            rounds = max(rounds, nr)
            for row, c, out, (t, first, dq, aq) in zip(lv, cf, got, types):
                serial = kernel_dp_model(row, c, first, int(dq), int(aq), lam,
                                         *table[t])
                plain = trellis_refine(
                    torch.from_numpy(row[None].astype(np.int32)),
                    torch.from_numpy(np.asarray(c)[None]), *tabs[t],
                    first=first, ctx0=1, dc_q=torch.tensor([int(dq)]),
                    ac_q=torch.tensor([int(aq)]), lam=torch.tensor([lam]))
                assert [out[_ZIGZAG[n]] for n in range(16)] == serial
                assert plain[0].tolist() == serial
                changed += serial != row.tolist()
    assert changed > 10 and rounds > 1


def _flat_tables(p, val_of_level):
    """Per-position tables with every bit costing ``p`` and level v's
    value cost ``val_of_level(v)`` under every context."""
    p0 = torch.full((16, 3, 2), p, dtype=torch.int32)
    val = torch.tensor([val_of_level(v) for v in range(68)],
                       dtype=torch.int32).expand(16, 3, 68).contiguous()
    return p0, p0.clone(), val


def _edge_case(kind, rng, first):
    """(tables, zigzag levels, raster coefficients, dc_q, ac_q, lam, what
    the case must show) of one constructed kind."""
    from gowebp_tpu_torch.ops.dct import _ZIGZAG

    R = 60
    pos = np.arange(16)
    sign = rng.choice([-1, 1], (R, 16))
    q = rng.integers(4, 40, R)
    lam = rng.integers(1, 40, R)
    if kind == "ties_flat":
        # value costs 8 v and free bits, q 4, lambda 1: a level v >= 2 of
        # coefficient 4 v - 1 costs 8 v + 1 kept and lowered, so keeping
        # and lowering tie; with every context alike, so do the states
        tabs = _flat_tables(0, lambda v: 8 * v)
        lv = rng.integers(0, 6, (R, 16)) * (rng.random((R, 16)) < 0.6)
        lv[:, first] = rng.integers(2, 6, R)
        q, lam = np.full(R, 4), np.ones(R, np.int64)
        mag = np.where(lv > 0, 4 * lv - 1, 0)
        return tabs, sign * lv, mag, q, q, lam, "ties"
    if kind == "ties_mixed":
        # bit costs 0 or 256 by context and small value costs: equal sums
        # of different paths, contexts and predecessors
        p0 = torch.from_numpy(rng.choice([0, 256], (16, 3, 2)).astype(np.int32))
        p1 = torch.from_numpy(rng.choice([0, 256], (16, 3, 2)).astype(np.int32))
        val = torch.from_numpy((rng.integers(0, 3, (16, 3, 68)) * 256)
                               .astype(np.int32))
        tabs = (p0, p1, val)
        lv = rng.integers(0, 4, (R, 16)) * (rng.random((R, 16)) < 0.7)
        q, lam = np.full(R, 16), rng.integers(1, 3, R)
        mag = np.where(lv > 0, 16 * lv - rng.choice([0, 8], (R, 16)), 0)
        mag = mag + rng.integers(-1, 2, (R, 16)) * (lv > 0)
        return tabs, sign * lv, mag, q, q, lam, "ties"
    tabs = _perturbed_tables(rng, 0 if first else rng.integers(1, 4))
    if kind == "last15":                 # the only non-zero at 15: no EOB
        lv = np.zeros((R, 16), np.int64)
        lv[:, 15] = rng.integers(1, 90, R)
    elif kind == "single_one":           # one |l| = 1: no lowered state
        lv = np.zeros((R, 16), np.int64)
        lv[pos[None] == rng.integers(first, 16, R)[:, None]] = 1
    elif kind == "all_zero":             # nothing to refine (a DC with first 1)
        lv = np.zeros((R, 16), np.int64)
        if first:
            lv[:, 0] = rng.integers(1, 9, R)
    elif kind == "past_67":              # value costs clamped at 67
        lv = rng.integers(60, 2048, (R, 16)) * (rng.random((R, 16)) < 0.5)
        lv[:, 15] = rng.integers(66, 70, R)
    else:                                # "dense": every position non-zero
        lv = rng.integers(1, 6, (R, 16))
    near = lv * q[:, None] + rng.integers(-1, 2, (R, 16)) * (q[:, None] // 2)
    mag = np.where(lv > 0, np.abs(near), rng.integers(0, 3, (R, 16)))
    return tabs, sign * lv, mag, q, q, lam, kind


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("kind", ["ties_flat", "ties_mixed", "last15",
                                  "single_one", "all_zero", "past_67",
                                  "dense"])
def test_lanes_trellis_model_on_edge_blocks(kind, first):
    """The lane model, the serial DP and the plain trellis agree on
    constructed blocks: forced ties (two paths of equal int64 cost, where
    the strict comparison keeps the unlowered level and the lower
    predecessor), a lone non-zero at 15 (no end-of-block bit), a lone
    |l| = 1 (no lowered state), all-zero blocks, levels past the 67
    clamp, every position non-zero."""
    from gowebp_tpu_torch.ops.dct import _ZIGZAG

    rng = np.random.default_rng(sum(map(ord, kind)) + first)
    tabs, lv, mag, dc_q, ac_q, lam, what = _edge_case(kind, rng, first)
    zz = np.asarray(lv)                                    # zigzag levels
    cf = np.zeros_like(zz)
    cf[:, list(_ZIGZAG)] = np.sign(zz) * mag + (zz == 0) * mag
    changed, ties, _, rounds = _hold_lanes_model(tabs, zz, cf, dc_q, ac_q, lam,
                                                 first)
    if what == "ties":
        assert ties > 20
    if what in ("single_one", "all_zero"):
        assert changed == 0
    if what in ("past_67", "dense", "last15"):
        assert changed > 0
    if what in ("past_67", "dense"):
        assert rounds > 1              # 5 blocks' non-zeros past 16 lanes


def test_lanes_trellis_scores_stay_in_range():
    """The largest inputs the kernel's no-saturation bound allows (int32
    lambda 2^31 - 1, every table entry 65535, steps 4095, levels 2047,
    coefficients below 2^16): every score stays in int64 and every finite
    one under 2^55, and the three DPs agree."""
    from gowebp_tpu_torch.ops.dct import _ZIGZAG

    rng = np.random.default_rng(3)
    R = 40
    tabs = _flat_tables(65535, lambda v: 65535)
    zz = rng.integers(0, 2048, (R, 16)) * (rng.random((R, 16)) < 0.7)
    zz[:, 3] = 2047
    cf = np.zeros_like(zz)
    cf[:, list(_ZIGZAG)] = rng.integers(0, 1 << 16, (R, 16)) * rng.choice(
        [-1, 1], (R, 16))
    lam = np.full(R, (1 << 31) - 1)
    _, _, seen, _ = _hold_lanes_model(tabs, zz, cf, 4095, 4095, lam, 0)
    assert seen > 1 << 52                      # near the bound, under it
