"""PyTorch port, open-loop engine, against the JAX package on CPU, bit for
bit (tolerance 0: the codec is integer math).

- the luma and chroma kernels' plain versions vs the TPU kernels
  ``_run_luma``/``_run_chroma`` in interpret mode;
- ``encode_plane_core_v2`` vs the JAX plane engine and its Pallas form;
- ``encode_rgba_batch(engine="openloop", device="cpu")`` vs the JAX
  pipeline's ``engine="openloop"`` bytes, and Pillow decodes them.
"""

import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined as jax_pipe
from gowebp_tpu.ops.encode_plane_jax import (_encode_plane_step_xla, _fwht_grid,
                                             _quant_plane, _regroup_mb_blocks)
from gowebp_tpu.ops.pallas.encode_plane import (_run_chroma, _run_luma,
                                                encode_plane_step_pallas)
from gowebp_tpu_torch import encode_rgba_batch
from gowebp_tpu_torch.models.vp8.encoder import (_default_cost_tables,
                                                 make_quants, quality_to_q)
from gowebp_tpu_torch.ops.encode_plane import encode_plane_core_v2
from gowebp_tpu_torch.ops.kernels.encode_plane import (
    encode_chroma, encode_chroma_plain, encode_luma, encode_luma_plain)
from gowebp_tpu_torch.utils.corpus import natural_image, natural_images

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("ymode", "uvmode", "y_levels", "y2_levels", "uv_levels")
# tests/test_pallas_ops.py's two quantizer sets, and q99's (small steps:
# levels leave int8)
Q_A = dict(y1_dc=8, y1_ac=17, y2_dc=16, y2_ac=34, uv_dc=8, uv_ac=17)
Q_B = dict(y1_dc=24, y1_ac=40, y2_dc=48, y2_ac=80, uv_dc=20, uv_ac=35)
_q99 = make_quants(quality_to_q(99.0))
Q_99 = {k: getattr(_q99, k).q for k in Q_A}

_luma_jit = jax.jit(_run_luma, static_argnums=(1, 2))
_chroma_jit = jax.jit(_run_chroma, static_argnums=(2, 3))


def _planes(kind, b, h, w, seed):
    """uint8 (y, u, v): random, or ("extremes", b=2) image 0 constant
    (every mode ties) and image 1 a 0/255 checkerboard of 1-pixel cells
    (large levels)."""
    rng = np.random.default_rng(seed)
    shapes = ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))
    if kind == "random":
        return tuple(rng.integers(0, 256, s).astype(np.uint8) for s in shapes)
    out = []
    for s, c in zip(shapes, (93, 130, 61)):
        p = np.full(s, c, np.uint8)
        p[1] = (np.indices(s[1:]).sum(0) & 1) * 255
        out.append(p)
    return tuple(out)


def _quants(q, dc, ac, bias_dc, bias_ac):
    return ((1 << 17) // q[dc], bias_dc, (1 << 17) // q[ac], bias_ac)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a.astype(np.int32))


KERNEL_CASES = [((2, 32, 64), Q_A), ((1, 16, 64), Q_B), ((1, 64, 16), Q_99)]


@pytest.mark.parametrize("shape,q", KERNEL_CASES)
def test_luma_plain_matches_tpu_kernel(shape, q):
    """The luma kernel also runs the Y2 path that the JAX package runs in
    XLA around ``_run_luma``: its expected output composes the two."""
    y, _, _ = _planes("random", *shape, seed=shape[1] + shape[2])
    quants = _quants(q, "y1_dc", "y1_ac", 96 << 9, 110 << 9)
    y2q = _quants(q, "y2_dc", "y2_ac", 96 << 9, 96 << 9)
    ymode, levels, y2_levels = encode_luma_plain(_t(y), quants, y2q)
    jlev, jdc_rows, jmodes = _luma_jit(_j(y), quants, True)
    np.testing.assert_array_equal(ymode.numpy(), np.asarray(jmodes)[:, :, ::16])
    np.testing.assert_array_equal(levels.numpy(),
                                  np.asarray(_regroup_mb_blocks(jlev, 16)))
    y2 = _quant_plane(_fwht_grid(jdc_rows[:, :, 0::4]), *y2q, False)
    np.testing.assert_array_equal(
        y2_levels.numpy(), np.asarray(_regroup_mb_blocks(y2, 4))[:, :, :, 0])
    assert ymode.dtype == torch.uint8
    assert levels.dtype == y2_levels.dtype == torch.int16


@pytest.mark.parametrize("shape,q", KERNEL_CASES)
def test_chroma_plain_matches_tpu_kernel(shape, q):
    _, u, v = _planes("random", *shape, seed=shape[1] * shape[2])
    quants = _quants(q, "uv_dc", "uv_ac", 110 << 9, 110 << 9)
    uvmode, levels = encode_chroma_plain(_t(u), _t(v), quants)
    ulev, vlev, jmodes = _chroma_jit(_j(u), _j(v), quants, True)
    np.testing.assert_array_equal(uvmode.numpy(), np.asarray(jmodes)[:, :, ::8])
    want = np.concatenate([np.asarray(_regroup_mb_blocks(ulev, 8)),
                           np.asarray(_regroup_mb_blocks(vlev, 8))], axis=3)
    np.testing.assert_array_equal(levels.numpy(), want)


CORE_CASES = [
    ("random", (1, 16, 16), Q_A),
    ("random", (2, 64, 128), Q_A),
    ("random", (1, 48, 256), Q_A),
    ("random", (2, 32, 64), Q_B),
    ("extremes", (2, 32, 64), Q_99),  # constant, then a checkerboard
    ("random", (1, 16, 64), Q_B),     # one MB row
    ("random", (1, 64, 16), Q_B),     # one MB column
]


@pytest.mark.parametrize("kind,shape,q", CORE_CASES)
def test_core_matches_jax_plane_engine_and_pallas(kind, shape, q):
    y, u, v = _planes(kind, *shape, seed=sum(shape))
    got = encode_plane_core_v2(_t(y), _t(u), _t(v), **q)
    ref = _encode_plane_step_xla(_j(y), _j(u), _j(v), **q)
    pal = encode_plane_step_pallas(_j(y), _j(u), _j(v), **q)  # interpret on CPU
    assert set(got) == set(KEYS)
    for k in KEYS:
        want = np.asarray(ref[k])
        assert got[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
        np.testing.assert_array_equal(np.asarray(pal[k]), want, err_msg=k)
    if kind == "extremes":
        # all four modes tie on the constant image: the first (DC) wins
        assert not got["ymode"][0, 1:, 1:].any()
        assert not got["uvmode"][0, 1:, 1:].any()
        assert got["y_levels"][1].abs().max() > 127


def test_core_modes_equal_hybrid_cold_search():
    """The hybrid's cold round decides its i16 and uv modes with the same
    source context, edge fills, DC rule and ties as the open-loop kernels."""
    from gowebp_tpu_torch.ops.encode_wavefront import openloop_mode_search

    B, H, W = 2, 48, 80
    y, u, v = (_t(p) for p in _planes("random", B, H, W, seed=17))
    y[0, :16] = 120                          # flat MBs: ties in both searches
    u[0, :8] = 77
    v[0, :8] = 77
    got = encode_plane_core_v2(y, u, v, **Q_A)
    mh, mw = H // 16, W // 16
    qs = torch.tensor(list(Q_A.values()), dtype=torch.int32).expand(B, 4, 6)
    tables = tuple(torch.from_numpy(t.astype(np.int32))
                   for t in _default_cost_tables())
    cold = openloop_mode_search(
        y, u, v, torch.zeros((B, mh, mw), dtype=torch.int32), qs, tables,
        try_i4=False, i4_penalty=torch.zeros((B, 4), dtype=torch.int32))
    assert torch.equal(got["ymode"].to(torch.int32), cold["ymode"])
    assert torch.equal(got["uvmode"].to(torch.int32), cold["uvmode"])


def test_kernel_wrappers_route_cpu_tensors_to_plain_versions():
    y, u, v = (_t(p) for p in _planes("random", 1, 32, 48, seed=2))
    lq = _quants(Q_A, "y1_dc", "y1_ac", 96 << 9, 110 << 9)
    y2q = _quants(Q_A, "y2_dc", "y2_ac", 96 << 9, 96 << 9)
    cq = _quants(Q_A, "uv_dc", "uv_ac", 110 << 9, 110 << 9)
    before = (encode_luma.launches, encode_chroma.launches)
    for a, b in zip(encode_luma(y, lq, y2q), encode_luma_plain(y, lq, y2q)):
        assert torch.equal(a, b)
    for a, b in zip(encode_chroma(u, v, cq), encode_chroma_plain(u, v, cq)):
        assert torch.equal(a, b)
    assert (encode_luma.launches, encode_chroma.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        encode_luma(y.to("meta"), lq, y2q)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------

def _images(n, h, w, seed):
    return [natural_image(h, w, seed=seed + i) for i in range(n)]


def _jax(images, quality):
    # chunk=2 everywhere: one JAX compilation per shape and quality
    return jax_pipe(images, quality=quality, chunk=2, engine="openloop")


def _decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(10 * np.log10(255.0 ** 2 / np.mean(d * d)))


@pytest.mark.parametrize("quality,h,w", [
    (75.0, 48, 64), (99.0, 48, 64), (75.0, 45, 61)])   # last: odd size
def test_openloop_batch_matches_jax(quality, h, w):
    imgs = _images(2, h, w, seed=3)
    got = encode_rgba_batch(imgs, quality=quality, device="cpu",
                            engine="openloop")
    assert got == _jax(imgs, quality)
    for data, im in zip(got, imgs):
        assert _decode(data).shape == im.shape          # Pillow decodes it
    hybrid = encode_rgba_batch(imgs, quality=quality, device="cpu")
    assert hybrid != got


def test_openloop_level_escape_matches_jax(monkeypatch):
    """A checkerboard at q99 drives |level| > 127: the image takes the
    dense-levels path and the bytes still match."""
    import gowebp_tpu_torch.ops.encode_pipeline as pipe

    rng = np.random.default_rng(5)
    im = np.repeat((rng.integers(0, 2, (48, 64, 1)) * 255).astype(np.uint8),
                   3, axis=2)
    seen = []
    real = pipe.emit_frame_arrays

    def spy(y2, yl, uvl, *a, **k):
        seen.append(max(np.abs(y2).max(), np.abs(yl).max(), np.abs(uvl).max()))
        return real(y2, yl, uvl, *a, **k)

    monkeypatch.setattr(pipe, "emit_frame_arrays", spy)
    imgs = [im, _images(1, 48, 64, seed=1)[0]]
    got = encode_rgba_batch(imgs, quality=99.0, device="cpu",
                            engine="openloop")
    assert max(seen) > 127, "fixture too tame"   # emits run in threads
    assert got == _jax(imgs, 99.0)
    assert _decode(got[0]).shape == im.shape


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_openloop_psnr_floor_of_chip_smoke():
    """chip_smoke.py fails an open-loop decode under OPENLOOP_PSNR_FLOOR_DB,
    set 3 dB under the JAX open-loop's minimum PSNR on 4 natural images at
    256x256, q75 (pytest -s prints them)."""
    imgs = list(natural_images(4, 256, 256, seed=7))
    ref = _jax(imgs, 75.0)
    assert encode_rgba_batch(imgs, device="cpu", engine="openloop") == ref
    scores = [_psnr(_decode(d), im) for d, im in zip(ref, imgs)]
    print(f"JAX open-loop PSNR, 4 x 256x256 q75 (Pillow decode): "
          f"{', '.join(f'{s:.3f}' for s in scores)} dB; min {min(scores):.3f}")
    floor = _chip_smoke().OPENLOOP_PSNR_FLOOR_DB
    assert min(scores) - 3.1 < floor <= min(scores) - 3.0


def test_engine_argument():
    import gowebp_tpu

    im = np.zeros((32, 32, 3), np.uint8)
    # "wavefront" (the exact full search) is an engine like the others
    assert (encode_rgba_batch([im], device="cpu", engine="wavefront")
            == jax_pipe([im], quality=75.0, chunk=1, engine="wavefront"))
    with pytest.raises(ValueError, match="unknown engine"):
        encode_rgba_batch([im], device="cpu", engine="fast")
    # a batch of mixed shapes, all opaque, gives the reference's bytes (its
    # per-image host encode), whatever the engine
    mixed = [im, np.zeros((32, 48, 3), np.uint8)]
    assert (encode_rgba_batch(mixed, device="cpu", engine="openloop")
            == gowebp_tpu.encode_rgba_batch(mixed, engine="openloop"))


def test_openloop_default_device_is_cuda_and_raises_without_it(monkeypatch):
    import gowebp_tpu_torch.ops.encode_pipeline as pipe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(pipe, "encode_plane_core_v2",
                        lambda *a, **k: ran.append(1))
    im = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_rgba_batch([im, im], engine="openloop")
    assert not ran
