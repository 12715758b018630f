"""PyTorch port, the batch decode of mixed batches: lossy, lossy + ALPH and
VP8L files in one call, on both reconstruction backends, against the JAX
package's ``decode_rgba_batch`` image for image, bit for bit.

The files come from Pillow (libwebp) and the JAX package's encoder.  The
JAX batch decode jit-compiles its recon per (shape, batch) group, so the
batch keeps to two lossy sizes and the JAX package decodes it in one
group (``threads=1``; its pixels do not depend on the thread count).
"""

import importlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

import gowebp_tpu
from gowebp_tpu_torch import decode_rgba_batch
from gowebp_tpu_torch.errors import BitstreamError
from gowebp_tpu_torch.utils.corpus import natural_image


def _save(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _alpha(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    a = (255 * xx / max(w - 1, 1) + 40 * np.sin(yy / 3 + seed)).clip(0, 255)
    a[:h // 3, :w // 3] = 0                      # a hard edge
    return a.astype(np.uint8)


def _mixed_batch():
    """39 files: 30 lossy 16x16, 3 lossy + ALPH 16x16, 2 lossy 33x49 (odd),
    1 lossy + ALPH 33x49, and 3 VP8L (a photo, an RGBA, a palette)."""
    datas = []
    for s in range(30):
        datas.append(_save(natural_image(16, 16, seed=s), quality=30 + s))
    for s in range(3):
        rgba = np.dstack([natural_image(16, 16, seed=40 + s),
                          _alpha(16, 16, s)])
        datas.insert(5 + 9 * s, _save(rgba, quality=70))
    for s in range(2):
        datas.insert(3 + 7 * s, _save(natural_image(33, 49, seed=50 + s),
                                      quality=60))
    datas.insert(20, _save(np.dstack([natural_image(33, 49, seed=52),
                                      _alpha(33, 49, 3)]), quality=75))
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    lossless = [
        _save(natural_image(20, 24, seed=60), lossless=True),
        _save(np.dstack([natural_image(16, 16, seed=61), _alpha(16, 16, 4)]),
              lossless=True, exact=True),
        _save(pal[rng.integers(0, 7, (17, 9))], lossless=True),
    ]
    for k, data in zip((0, 17, 38), lossless):
        datas.insert(k, data)
    return datas


DATAS = _mixed_batch()


@pytest.fixture(scope="module")
def jax_rgba():
    return [np.asarray(r) for r in
            gowebp_tpu.decode_rgba_batch(DATAS, threads=1,
                                         recon_backend="jax")]


def test_mixed_batch_has_every_kind():
    from gowebp_tpu_torch.container.riff import parse_riff

    kinds = []
    for d in DATAS:
        p = parse_riff(d)
        kinds.append("vp8l" if p.find(b"VP8L") else
                     "alpha" if p.find(b"ALPH") else "vp8")
    assert len(DATAS) > 32
    assert kinds.count("vp8l") == 3 and kinds.count("alpha") == 4


def test_mixed_batch_matches_jax(jax_rgba):
    timings = {}
    got = decode_rgba_batch(DATAS, device="cpu", threads=2, timings=timings)
    assert len(got) == len(DATAS)
    for g, w in zip(got, jax_rgba):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    for k in ("symbols_s", "alpha_s", "vp8l_s", "pack_s"):
        assert timings[k] > 0
    assert "recon_host_s" not in timings
    assert set(timings["stage_ms"]) == {"h2d", "unpack", "idct", "recon",
                                        "filter", "yuv420_to_rgba", "d2h"}
    assert timings["h2d_bytes"] > 0


@pytest.mark.parametrize("threads", [1, 2])
def test_host_backend_matches_jax_host_and_device(jax_rgba, threads):
    timings = {}
    got = decode_rgba_batch(DATAS, device="cpu", threads=threads,
                            recon_backend="host", timings=timings)
    want = gowebp_tpu.decode_rgba_batch(DATAS, threads=threads,
                                        recon_backend="host")
    for g, w, d in zip(got, want, jax_rgba):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, d)
    assert timings["recon_host_s"] > 0 and "stage_ms" not in timings


@pytest.mark.parametrize("backend", ["device", "host"])
def test_device_out_gives_tensors_equal_to_the_arrays(jax_rgba, backend):
    timings = {}
    got = decode_rgba_batch(DATAS, device="cpu", device_out=True, threads=2,
                            recon_backend=backend, timings=timings)
    for g, w in zip(got, jax_rgba):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.uint8
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    # the host-decoded images went up in one copy per shape: with the
    # host backend every 16x16 image is a view of one batch
    assert "h2d_host_rgba" in timings["stage_ms"]
    if backend == "host":
        small = [g for g in got if tuple(g.shape) == (16, 16, 4)]
        assert len(small) == 34
        assert len({g.untyped_storage().data_ptr() for g in small}) == 1


def test_file_without_an_image_chunk_raises_in_both(monkeypatch):
    """Before any work in the port: no symbol or VP8L decode runs."""
    dec = importlib.import_module("gowebp_tpu_torch.decode")

    bad = b"RIFF\x0c\x00\x00\x00WEBPJUNK\x00\x00\x00\x00"
    ran = []
    monkeypatch.setattr(dec, "decode_vp8_symbols_batch",
                        lambda *a, **k: ran.append(1))
    monkeypatch.setattr(dec, "decode_vp8l", lambda *a, **k: ran.append(1))
    with pytest.raises(BitstreamError):
        decode_rgba_batch(DATAS[:3] + [bad], device="cpu")
    assert not ran
    with pytest.raises(gowebp_tpu.errors.BitstreamError):
        gowebp_tpu.decode_rgba_batch(DATAS[:3] + [bad])


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="recon_backend"):
        decode_rgba_batch(DATAS[:2], device="cpu", recon_backend="jax")
