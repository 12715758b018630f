"""PyTorch port: bit accounting, the host metrics and ``__version__``
against the JAX package's."""

import io

import numpy as np
import pytest
from PIL import Image

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.config import EncoderConfig
from gowebp_tpu.utils import bittrace as ref_bt
from gowebp_tpu.utils import metrics as ref_metrics
from gowebp_tpu_torch.utils import bittrace as port_bt
from gowebp_tpu_torch.utils import metrics as port_metrics

from util import make_test_images

IMAGES = make_test_images()
PHOTO = IMAGES["photo"][..., :3].copy()


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _pil(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


LOSSY = {
    **{f"partitions_{1 << p}": lambda p=p: gowebp_tpu.encode_rgba(
        PHOTO, config=EncoderConfig(quality=80, partitions=p))
       for p in range(4)},
    "segments_1": lambda: gowebp_tpu.encode_rgba(
        PHOTO, config=EncoderConfig(quality=50, segments=1)),
    "segments_4": lambda: gowebp_tpu.encode_rgba(
        PHOTO, config=EncoderConfig(quality=50, segments=4)),
    "i4_heavy": lambda: gowebp_tpu.encode_rgba(_noise(48, 64, 2),
                                               quality=95.0),
    "alph": lambda: gowebp_tpu.encode_rgba(IMAGES["alpha_noise"]),
    "pillow_q60": lambda: _pil(_noise(48, 64, 2), quality=60),
    "pillow_odd": lambda: _pil(PHOTO[:37, :51].copy(), quality=30),
}

LOSSLESS = {
    "palette4": lambda: _pil(IMAGES["palette4"], lossless=True),
    "palette2": lambda: _pil(IMAGES["palette2"], lossless=True),
    "predictor": lambda: _pil(IMAGES["gradient"], lossless=True,
                              quality=100, method=6),
    "colour_cache": lambda: _pil(PHOTO, lossless=True, quality=100,
                                 method=4),
    "reference_palette": lambda: gowebp_tpu.encode_rgba(
        IMAGES["palette4"], lossless=True),
    "reference_photo": lambda: gowebp_tpu.encode_rgba(PHOTO, lossless=True),
    "reference_alpha": lambda: gowebp_tpu.encode_rgba(
        IMAGES["alpha_noise"], lossless=True),
}


@pytest.mark.parametrize("name", sorted(LOSSY))
def test_bit_accounting_lossy_equals_the_reference(name):
    data = LOSSY[name]()
    want = ref_bt.bit_accounting(data)
    got = port_bt.bit_accounting(data)
    assert got == want
    c = got["classes"]
    assert 0 < sum(c.values()) <= got["total_bits"]
    assert sum(got["residuals_per_partition"]) == c["residuals"]
    if name.startswith("partitions_"):
        assert len(got["residuals_per_partition"]) == int(name.split("_")[1])


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_bit_accounting_lossless_equals_the_reference(name):
    data = LOSSLESS[name]()
    want = ref_bt.bit_accounting(data)
    got = port_bt.bit_accounting(data)
    assert got == want
    assert got["format"] == "lossless"
    assert 0 < sum(got["classes"].values()) <= got["total_bits"]


def test_bit_accounting_lossless_classes_vary():
    """The lossless cases cover transforms, meta prefix codes and
    prefix codes of several sizes."""
    seen = [port_bt.bit_accounting(f())["classes"] for f in LOSSLESS.values()]
    assert len({c["transforms"] for c in seen}) > 2
    assert len({c["meta_huffman"] for c in seen}) > 1


@pytest.mark.parametrize("data", [
    b"RIFF\x04\x00\x00\x00WEBP",
    b"RIFF\x0c\x00\x00\x00WEBPANIM\x00\x00\x00\x00",
    b"not a webp file at all",
])
def test_bit_accounting_bad_files_raise_the_reference_class(data):
    with pytest.raises(Exception) as want:
        ref_bt.bit_accounting(data)
    with pytest.raises(Exception) as got:
        port_bt.bit_accounting(data)
    assert got.type.__name__ == want.type.__name__


def test_bit_accounting_of_an_animation_raises_value_error():
    frames = [Image.fromarray(_noise(16, 16, s)) for s in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=10)
    for mod in (ref_bt, port_bt):
        with pytest.raises(ValueError):
            mod.bit_accounting(buf.getvalue())


def _pairs():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (40, 36, 4), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    return {
        "rgba": (a, b),
        "rgb": (a[..., :3], b[..., :3]),
        "two_channels": (a[..., :2], b[..., :2]),
        "plane": (a[..., 0], b[..., 0]),
        "equal": (a, a.copy()),
        "small_equal": (a[:5, :7], a[:5, :7].copy()),
        "small_differ": (a[:5, :7], b[:5, :7]),
        "odd_size": (a[:37, :29], b[:37, :29]),
        "far": (a, 255 - a),
    }


PAIRS = _pairs()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plane_psnr_and_ssim_equal_the_reference(name):
    a, b = PAIRS[name]
    assert port_metrics.psnr(a, b) == ref_metrics.psnr(a, b)
    if a.ndim == 3:
        assert port_metrics.plane_psnr(a, b) == ref_metrics.plane_psnr(a, b)
    if a.ndim == 3 and a.shape[-1] < 3:
        return                     # SSIM takes a plane or RGB(A)
    for window in (8, 4, 16):
        got = port_metrics.ssim(a, b, window=window)
        assert isinstance(got, float)
        assert got == ref_metrics.ssim(a, b, window=window)


def test_ssim_smaller_than_the_window():
    a, b = PAIRS["small_differ"]
    assert port_metrics.ssim(a, b) == ref_metrics.ssim(a, b) == 0.0
    a, b = PAIRS["small_equal"]
    assert port_metrics.ssim(a, b) == ref_metrics.ssim(a, b) == 1.0


def test_version_equals_the_reference():
    assert gowebp_tpu_torch.__version__ == gowebp_tpu.__version__ == "0.1.0"
    assert "__version__" in gowebp_tpu_torch.__all__
