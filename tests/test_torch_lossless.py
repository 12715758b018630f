"""PyTorch port, the lossless encode (``encode_rgba(lossless=True)``,
``near_lossless``) on ``device="cpu"`` against the JAX package.

- ``.webp`` bytes and the lossless ``EncodeStats`` fields bit for bit
  (tolerance 0: the host chooser and every other decision are the same
  float64 numpy and native code): sizes 1x1 to 64x48, RGB and RGBA,
  qualities 0-100 and methods 0-6 (every gate of ``_crunch_params`` and
  ``_write_spatial_stream``), ``image_hint``, palettes of 2-256 colours,
  ``near_lossless`` and ``exact``;
- the device chooser's form on the CPU ($GOWEBP_TPU_VP8L_ANALYSIS=1 in
  both packages): files round-trip, and the port's is at most 1.005x the
  host chooser's (the JAX package's own rule for its float32 chooser);
- ``predictor_search_entropy_plain`` (the kernel's plain version, integer
  scores) against the JAX ``predictor_search_entropy`` (float32) and the
  host chooser (float and double): at least 95% of tiles agree, and with
  no refinement every tile where it and the JAX function differ is a
  near tie (float64 scores within 1e-4 relative);
- its parts: the 14 predictors against the JAX ``predict_plane``, the
  fixed-point tables' int64 bound;
- ``_choose_predictors_auto``'s routing (host chooser, plain version,
  kernel) and that a failing device chooser raises.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.config import EncoderConfig as JConfig
from gowebp_tpu.stats import EncodeStats as JStats
from gowebp_tpu_torch import EncoderConfig, EncodeStats
from gowebp_tpu_torch.models.vp8l import encoder as penc
from gowebp_tpu_torch.ops import lossless as L
from gowebp_tpu_torch.ops.kernels import vp8l_predictor as K

STATS = ("transforms", "cache_bits", "num_huffman_groups", "palette_size",
         "lossless_size", "coded_size")
SWITCH = "GOWEBP_TPU_VP8L_ANALYSIS"


def _image(h, w, seed, alpha=None):
    """A seeded photographic-ish image; ``alpha``: None (RGB), "soft" (a
    noisy ramp with a transparent corner) or "holes" (0/255 16x16
    blocks)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([120 + 60 * np.sin(xx / 5), 110 + 50 * np.cos(yy / 4),
                    (3 * xx + 2 * yy) % 256], -1)
    rgb = (rgb + rng.normal(0, 14, rgb.shape)).clip(0, 255).astype(np.uint8)
    if alpha is None:
        return rgb
    if alpha == "soft":
        a = 255 * xx / max(w - 1, 1) + rng.integers(-30, 30, (h, w))
        a[: h // 3, : w // 3] = 0
    else:
        a = np.where(((yy // 16) + (xx // 16)) % 3 == 0, 0, 255)
    return np.dstack([rgb, a.clip(0, 255).astype(np.uint8)])


def _palette_image(n, h=40, w=56, seed=9):
    """An image of exactly ``n`` colours (opaque but for one)."""
    rng = np.random.default_rng(seed + n)
    pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    pal[:, 3] = 255
    pal[-1, 3] = 128
    idx = rng.integers(0, n, (h, w))
    idx.reshape(-1)[:n] = np.arange(n)
    return pal[idx]


def _assert_same(img, **kw):
    js, ps = JStats(), EncodeStats()
    want = gowebp_tpu.encode_rgba(img, config=JConfig(lossless=True, **kw),
                                  stats=js)
    got = gowebp_tpu_torch.encode_rgba(
        img, config=EncoderConfig(lossless=True, **kw), stats=ps,
        device="cpu")
    assert got == want
    for name in STATS:
        assert getattr(ps, name) == getattr(js, name), name
    return got


def _decoded(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


# ---------------------------------------------------------------------------
# Bytes and statistics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [None, "soft"])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 64), (64, 1), (33, 17),
                                 (64, 48)])
def test_sizes(h, w, alpha):
    img = _image(h, w, seed=h * 100 + w, alpha=alpha)
    data = _assert_same(img)
    rgba = img if alpha else np.dstack([img, np.full((h, w), 255, np.uint8)])
    out = _decoded(data)
    # transparent pixels' RGB is cleaned up unless exact
    vis = rgba[..., 3] > 0
    assert np.array_equal(out[vis], rgba[vis])


@pytest.mark.parametrize("quality", [0, 5, 15, 22, 27, 40, 60, 75, 95, 100])
def test_qualities(quality):
    _assert_same(_image(64, 48, seed=2), quality=quality)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("method", range(7))
def test_methods(method, quality):
    _assert_same(_image(48, 64, seed=3 + method, alpha="holes"),
                 method=method, quality=quality)


@pytest.mark.parametrize("hint", [2, 3])     # ImageHint.PHOTO, GRAPH
@pytest.mark.parametrize("kind", ["photo", "palette100"])
def test_image_hints(hint, kind):
    img = _image(40, 52, seed=5) if kind == "photo" else _palette_image(100)
    _assert_same(img, image_hint=hint)


def test_out_of_range_image_hint_is_not_validated():
    """Neither package range-checks ``image_hint`` (the reference's
    ``validate`` has no such check): hint 9 encodes, with the same
    bytes."""
    JConfig(lossless=True, image_hint=9).validate()
    EncoderConfig(lossless=True, image_hint=9).validate()
    assert _assert_same(_image(40, 52, seed=5), image_hint=9)


@pytest.mark.parametrize("quality,method", [(75, 4), (95, 6), (30, 4)])
@pytest.mark.parametrize("n", [2, 4, 16, 64, 65, 256])
def test_palettes(n, quality, method):
    img = _palette_image(n)
    data = _assert_same(img, quality=quality, method=method)
    assert np.array_equal(_decoded(data), img)


@pytest.mark.parametrize("alpha", [None, "soft"])
@pytest.mark.parametrize("near", [0, 40, 60, 80])
def test_near_lossless(near, alpha):
    _assert_same(_image(40, 48, seed=7, alpha=alpha), near_lossless=near)


@pytest.mark.parametrize("exact", [False, True])
def test_exact_with_holed_alpha(exact):
    img = _image(48, 64, seed=8, alpha="holes")
    data = _assert_same(img, exact=exact)
    if exact:
        assert np.array_equal(_decoded(data), img)


def test_stats_default_and_rejects():
    """A stats-less call gives the same bytes; bad arrays raise the
    reference's class."""
    img = _image(33, 40, seed=11)
    with_stats = _assert_same(img, method=5)
    assert gowebp_tpu_torch.encode_rgba(
        img, lossless=True, method=5, device="cpu") == with_stats
    for bad in (np.zeros((8, 8), np.uint8), np.zeros((8, 8, 2), np.uint8)):
        with pytest.raises(gowebp_tpu.EncodeError):
            gowebp_tpu.encode_rgba(bad, lossless=True)
        with pytest.raises(gowebp_tpu_torch.EncodeError):
            gowebp_tpu_torch.encode_rgba(bad, lossless=True, device="cpu")


# ---------------------------------------------------------------------------
# The device chooser's form, on the CPU
# ---------------------------------------------------------------------------


def _parity_image():
    """tests/test_lossless_jax.py's size-parity image (144x176)."""
    rng = np.random.default_rng(5)
    h, w = 144, 176
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.clip(130 + 50 * np.sin(xx / 19)
                          + rng.normal(0, 4, (h, w)), 0, 255)
    img[..., 1] = np.clip(110 + 45 * np.cos(yy / 23), 0, 255)
    img[..., 2] = ((xx + 2 * yy) // 4) % 256
    return img


@pytest.mark.parametrize("kw", [{"quality": 75},
                                {"quality": 95, "method": 6}])
def test_forced_device_chooser_round_trips_at_size_parity(monkeypatch, kw):
    img = _parity_image()
    if kw.get("method") == 6:
        img = np.ascontiguousarray(img[:72, :88])
    host = gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(
        lossless=True, **kw), device="cpu")
    monkeypatch.setenv(SWITCH, "1")
    calls = K.predictor_search_entropy.calls
    forced = gowebp_tpu_torch.encode_rgba(img, config=EncoderConfig(
        lossless=True, **kw), device="cpu")
    jforced = gowebp_tpu.encode_rgba(img, config=JConfig(lossless=True, **kw))
    assert K.predictor_search_entropy.calls == calls   # no kernel on the CPU
    rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    for data in (forced, jforced):
        assert np.array_equal(_decoded(data), rgba)
        assert np.array_equal(
            gowebp_tpu_torch.decode_rgba(data, device="cpu"), rgba)
    assert len(forced) <= 1.005 * len(host), (len(forced), len(host))


# ---------------------------------------------------------------------------
# predictor_search_entropy_plain against the JAX function and the host
# ---------------------------------------------------------------------------


def _jax_image(h=160, w=192, seed=2):
    """tests/test_lossless_jax.py's chooser image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (120 + 60 * np.sin(xx / 23) + rng.normal(0, 6, (h, w)))
    g = (100 + 50 * np.cos(yy / 17) + 20 * np.sin((xx + yy) / 31))
    b = (xx // 3 + yy // 5) % 256
    argb = (0xFF000000
            | (np.clip(r, 0, 255).astype(np.uint32) << 16)
            | (np.clip(g, 0, 255).astype(np.uint32) << 8)
            | b.astype(np.uint32))
    return argb.astype(np.uint32)


def _noisy_argb(h, w, seed):
    """Smooth planes with small noise: many near ties between modes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(80 + yy // 3 + rng.integers(0, 3, (h, w))) % 256,
             (xx + yy) % 256, (2 * xx + rng.integers(0, 2, (h, w))) % 256]
    return (0xFF000000 | (chans[0] << 16) | (chans[1] << 8)
            | chans[2]).astype(np.uint32)


def _t(argb):
    return torch.from_numpy(np.ascontiguousarray(argb).view(np.int32))


def _stage1_scores_f64(argb, bits, tile, modes):
    """float64 stage-1 scores of ``modes`` on tile index ``tile``, from
    the tile's residual histograms."""
    h, w = argb.shape
    tw = -(-w // (1 << bits))
    ty, tx = divmod(tile, tw)
    sl = (slice(ty << bits, (ty + 1) << bits),
          slice(tx << bits, (tx + 1) << bits))
    x = L.to_words(_t(argb))
    out = []
    for m in modes:
        res = L._sub_pixels(x, L.predict_plane(x, m))[sl].numpy()
        n = res.size
        cost = 4.0 * n * np.log2(max(n, 1))
        for s in (24, 16, 8, 0):
            hist = np.bincount(((res >> s) & 0xFF).ravel(), minlength=256)
            hist = hist.astype(np.float64)
            folded = np.minimum(np.arange(256), 256 - np.arange(256))
            cost += (-(hist * np.log2(np.maximum(hist, 1.0))).sum()
                     + (hist * 0.04 * folded).sum())
        out.append(cost)
    return out


CHOOSER_CASES = [("jax_image", bits, iters) for bits in (3, 4, 5)
                 for iters in (0, 2, 4)] + [
    ("odd_37x53", 3, 2), ("odd_37x53", 5, 0), ("row_1x70", 4, 2),
    ("col_70x1", 4, 0), ("noisy_48x80", 3, 0), ("noisy_48x80", 4, 4)]


def _chooser_image(name):
    if name == "jax_image":
        return _jax_image()
    if name.startswith("noisy"):
        return _noisy_argb(48, 80, seed=4)
    h, w = (int(v) for v in name.split("_")[1].split("x"))
    return _jax_image(h, w, seed=h + w)


@pytest.mark.parametrize("name,bits,iters", CHOOSER_CASES)
def test_plain_chooser_against_jax_and_host(name, bits, iters):
    from gowebp_tpu.models.vp8l.encoder import _choose_predictors as j_host
    from gowebp_tpu.ops.lossless_jax import predictor_search_entropy as j_dev

    argb = _chooser_image(name)
    got = K.predictor_search_entropy_plain(_t(argb), bits, iters).numpy()
    jax = np.asarray(j_dev(argb, bits, refine_iters=iters))
    host = (j_host(argb, bits, refine_iters=iters) >> 8) & 0xFF
    assert got.shape == jax.shape == host.shape
    assert got.dtype == np.int32
    assert (got == jax).mean() >= 0.95, (got != jax).sum()
    assert (got == host).mean() >= 0.95, (got != host).sum()
    # the port's host chooser is the reference's
    assert np.array_equal((penc._choose_predictors(argb, bits, iters) >> 8)
                          & 0xFF, host)
    if iters == 0:
        for t in np.flatnonzero(got.ravel() != jax.ravel()):
            a, b = _stage1_scores_f64(argb, bits, int(t),
                                      (int(got.ravel()[t]),
                                       int(jax.ravel()[t])))
            assert abs(a - b) <= 1e-4 * max(abs(a), abs(b), 1.0), (t, a, b)


def test_plain_chooser_on_the_cpu_counts_no_launch():
    before = (K.predictor_search_entropy.launches,
              K.predictor_search_entropy.calls)
    argb = _jax_image(40, 36)
    got = L.predictor_search_entropy(_t(argb), 3, 2)
    assert torch.equal(got, K.predictor_search_entropy_plain(_t(argb), 3, 2))
    assert (K.predictor_search_entropy.launches,
            K.predictor_search_entropy.calls) == before


@pytest.mark.parametrize("bad", ["bits1", "bits6", "int64", "3d", "empty",
                                 "iters"])
def test_chooser_rejects_bad_inputs(bad):
    argb = _t(_jax_image(16, 16))
    args = {"bits1": (argb, 1, 2), "bits6": (argb, 6, 2),
            "int64": (argb.to(torch.int64), 3, 2),
            "3d": (argb[None], 3, 2), "empty": (argb[:0], 3, 2),
            "iters": (argb, 3, -1)}[bad]
    with pytest.raises((ValueError, TypeError)):
        L.predictor_search_entropy(*args)


# ---------------------------------------------------------------------------
# The plain version's parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(17, 21), (1, 9), (9, 1), (2, 2)])
def test_predict_plane_all_modes_against_jax(h, w):
    import jax.numpy as jnp

    from gowebp_tpu.ops.lossless_jax import _sub_pixels as j_sub
    from gowebp_tpu.ops.lossless_jax import predict_plane as j_predict

    rng = np.random.default_rng(h * 31 + w)
    argb = rng.integers(0, 2**32, (h, w), dtype=np.uint64).astype(np.uint32)
    x = L.to_words(_t(argb))
    for mode in range(14):
        pred = L.predict_plane(x, mode)
        want = np.asarray(j_predict(jnp.array(argb), mode))
        assert np.array_equal(pred.numpy().astype(np.uint32), want), mode
        res = L._sub_pixels(x, pred).numpy().astype(np.uint32)
        assert np.array_equal(res, np.asarray(j_sub(jnp.array(argb),
                                                    jnp.array(want)))), mode
    if h > 1 and w > 1:     # TR of the last column: the row's first pixel
        tr = L.predict_plane(x, 3).numpy().astype(np.uint32)
        assert np.array_equal(tr[1:, -1], argb[1:, 0])


def test_fixed_point_tables_fit_int64():
    """The largest scores the kernel can sum stay under 2^62: a full
    5-bit tile's stage 1 (every count, the largest bias) and a
    refinement round of a 16384 x 16384 image with an empty bin and a
    mode that no tile uses."""
    tab = L.stage1_table()
    nlogn, bias = tab[:L.MAX_COUNT + 1], tab[L.MAX_COUNT + 1:]
    assert len(nlogn) == 1025 and len(bias) == 256
    assert nlogn[0] == nlogn[1] == 0 and bias[0] == 0
    n = L.MAX_COUNT
    # sum(h log2 h) over a tile's 4n counts <= 4 n log2 n: each h <= n
    stage1 = 4 * int(nlogn[n]) + 4 * n * int(bias.max()) + 4 * int(nlogn[n])
    assert stage1 < 1 << 62
    glob = np.zeros(1024, np.int64)
    glob[::256] = 16384 * 16384
    tiles = (16384 >> L.MIN_BITS) ** 2
    mcount = np.zeros(14, np.int64)
    mcount[0] = tiles
    q = L.refine_table(glob, mcount, tiles)
    assert q.dtype == np.int64 and len(q) == 1024 + 14
    refine = 4 * n * int(q[:1024].max()) + int(q[1024:].max())
    assert refine < 1 << 62
    # both tables are exact multiples of 2^-SCALE_BITS of the float64s
    assert nlogn[2] == 2 << L.SCALE_BITS
    assert q[1024 + 1] == round(-np.log2(0.1 / (tiles + 1.4))
                                * 2.0 ** L.SCALE_BITS)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self, fn=None, exc=None):
        self.calls, self.fn, self.exc = [], fn, exc

    def __call__(self, *a, **k):
        self.calls.append(a)
        if self.exc is not None:
            raise self.exc
        return self.fn(*a, **k)


def test_routing_host_chooser_under_1mp_or_on_the_cpu(monkeypatch):
    monkeypatch.delenv(SWITCH, raising=False)
    host = _Recorder(penc._choose_predictors)
    device = _Recorder(exc=AssertionError("the device chooser ran"))
    monkeypatch.setattr(penc, "_choose_predictors", host)
    monkeypatch.setattr(penc, "_device_modes", device)
    small = _jax_image(64, 48)
    penc._choose_predictors_auto(small, 4, 2, 1, torch.device("cuda"))
    big = np.zeros((1024, 1024), np.uint32)
    penc._choose_predictors_auto(big, 5, 2, 2, torch.device("cpu"))
    assert [c[1:] for c in host.calls] == [(4,), (5,)]
    assert not device.calls


def test_routing_switch_runs_the_plain_version_on_the_cpu(monkeypatch):
    monkeypatch.setenv(SWITCH, "1")
    host = _Recorder(exc=AssertionError("the host chooser ran"))
    plain = _Recorder(K.predictor_search_entropy_plain)
    monkeypatch.setattr(penc, "_choose_predictors", host)
    monkeypatch.setattr(K, "predictor_search_entropy_plain", plain)
    argb = _jax_image(40, 56)
    got = penc._choose_predictors_auto(argb, 3, 2, 2, torch.device("cpu"))
    assert len(plain.calls) == 1 and plain.calls[0][1:] == (3, 2)
    want = K.predictor_search_entropy_plain(_t(argb), 3, 2).numpy()
    assert np.array_equal(got, (0xFF000000 | (want.astype(np.uint32) << 8)))
    assert not host.calls


def test_routing_kernel_at_1mp_on_a_cuda_device(monkeypatch):
    """Without a card: a CUDA device at 1 MP reaches the device chooser
    (its upload and launch replaced by a recorder), row_step ignored."""
    monkeypatch.delenv(SWITCH, raising=False)
    host = _Recorder(exc=AssertionError("the host chooser ran"))
    th = tw = 1024 >> 4

    def fake(argb, bits, refine_iters, device):
        return np.full((th, tw), 7, np.int32)

    device = _Recorder(fake)
    monkeypatch.setattr(penc, "_choose_predictors", host)
    monkeypatch.setattr(penc, "_device_modes", device)
    big = np.zeros((1024, 1024), np.uint32)
    got = penc._choose_predictors_auto(big, 4, 2, 2, torch.device("cuda"))
    assert len(device.calls) == 1
    assert device.calls[0][1:] == (4, 2, torch.device("cuda"))
    assert np.all(got == (0xFF000000 | (7 << 8)))
    assert not host.calls


def test_a_failing_device_chooser_raises(monkeypatch):
    """No fallback: a device chooser that raises fails the encode, from
    the photo path's thread pool too."""
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setattr(penc, "_device_modes",
                        _Recorder(exc=RuntimeError("launch failed")))
    img = _image(40, 48, seed=12)
    with pytest.raises(RuntimeError, match="launch failed"):
        gowebp_tpu_torch.encode_rgba(img, lossless=True, device="cpu")


def test_default_device_is_cuda_and_raises_before_any_work(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(penc, "encode_vp8l_stream",
                        lambda *a, **k: ran.append(1))
    img = _image(8, 8, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        gowebp_tpu_torch.encode_rgba(img, lossless=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        penc.encode_vp8l(img)
    assert not ran
