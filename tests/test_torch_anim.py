"""PyTorch port: the animation encoder and decoder on the CPU
(``device="cpu"``, the kernels' plain versions) against the JAX
package's: the same files, canvases and durations."""

import io

import numpy as np
import pytest
from PIL import Image

from gowebp_tpu.container import anim as ref_anim
from gowebp_tpu.container import mux as ref_mux
from gowebp_tpu_torch.container import anim as port_anim
from gowebp_tpu_torch.container.demux import demux


def _opaque(rng, h, w):
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[..., 3] = 255
    return f


def _delta_frames():
    """Rectangle changes, a repeat (merged) and a small change."""
    rng = np.random.default_rng(7)
    base = _opaque(rng, 40, 64)
    f2 = base.copy()
    f2[10:20, 30:44] = (255, 0, 0, 255)
    f3 = f2.copy()
    f3[0:4, 0:8] = (0, 255, 0, 255)
    return [base, f2, f2.copy(), f3]


def _key_frames():
    rng = np.random.default_rng(11)
    frames = [_opaque(rng, 24, 40)]
    for i in range(5):
        f = frames[-1].copy()
        f[4 * i: 4 * i + 4, 8:16] = (i * 30, 255 - i * 30, 0, 255)
        frames.append(f)
    return frames


def _erase_frames():
    """A big sprite, then most of it gone: the dispose-to-background
    candidate wins."""
    f0 = np.zeros((48, 48, 4), np.uint8)
    f1 = f0.copy()
    rng = np.random.default_rng(5)
    f1[6:42, 6:42] = _opaque(rng, 36, 36)
    f2 = f0.copy()
    f2[10:18, 10:18] = (0, 255, 0, 255)
    return [f0, f1, f2]


def _blank_frames():
    """Sparse changes inside a large rectangle: the blanking candidate
    wins."""
    rng = np.random.default_rng(12)
    base = _opaque(rng, 40, 56)
    f2 = base.copy()
    for i in range(6):
        f2[7 * (i % 5) + 2, 9 * i + 1] = (255, 0, 0, 255)
    return [base, f2]


def _alpha_frames():
    rng = np.random.default_rng(3)
    frames = []
    for i in range(3):
        f = rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)
        f[..., 3] = np.where(rng.random((32, 48)) < 0.3, 0,
                             rng.integers(1, 256, (32, 48)))
        f[: 8 + 4 * i, :16, 3] = 255
        frames.append(f)
    return frames


def _rgb_frames():
    return [np.ascontiguousarray(f[..., :3]) for f in _delta_frames()]


CASES = {
    "defaults": (_delta_frames, {}, {}),
    "lossy": (_delta_frames, {}, {"lossless": False, "quality": 60.0}),
    "allow_mixed": (_delta_frames, {"allow_mixed": True}, {"quality": 80.0}),
    "kmax1": (_key_frames, {"kmax": 1}, {}),
    "kmax3_kmin1": (_key_frames, {"kmax": 3, "kmin": 1}, {}),
    "kmax3_kmin5": (_key_frames, {"kmax": 3, "kmin": 5}, {}),
    "kmax3_kmin1_lossy": (_key_frames, {"kmax": 3, "kmin": 1},
                          {"lossless": False}),
    "kmax0": (_key_frames, {"kmax": 0, "kmin": 2}, {}),
    "dispose_background": (_erase_frames, {}, {}),
    "blanking": (_blank_frames, {}, {}),
    "rgb": (_rgb_frames, {}, {}),
    "rgb_lossy": (_rgb_frames, {}, {"lossless": False}),
    "alpha_lossless": (_alpha_frames, {}, {}),
    "alpha_lossy": (_alpha_frames, {}, {"lossless": False, "quality": 90.0}),
    "no_minimize": (_delta_frames, {"minimize_size": False}, {}),
    "params_single_frame": (lambda: _delta_frames()[:1],
                            {"loop_count": 5, "background_color": 0x11223344},
                            {}),
}


def _encode(mod, frames, enc_kw, add_kw, **extra):
    enc = mod.AnimationEncoder(**enc_kw, **extra)
    for i, f in enumerate(frames):
        enc.add_frame(f, 40 + 10 * i, **add_kw)
    return enc.assemble()


def _same_canvases(data):
    want, _ = ref_anim.decode_animation(data)
    got, gd = port_anim.decode_animation(data, device="cpu")
    assert [f.duration_ms for f in got] == [f.duration_ms for f in want]
    assert len(got) == len(want) == gd.num_frames
    for a, b in zip(got, want):
        assert a.rgba.dtype == np.uint8
        np.testing.assert_array_equal(a.rgba, b.rgba)
    return got, gd


@pytest.mark.parametrize("case", sorted(CASES))
def test_animation_encoder_gives_the_reference_bytes(case):
    make, enc_kw, add_kw = CASES[case]
    frames = make()
    want = _encode(ref_anim, frames, enc_kw, add_kw)
    got = _encode(port_anim, frames, enc_kw, add_kw, device="cpu")
    assert got == want
    _same_canvases(got)


def test_policies_show_in_the_files():
    """The cases exercise what they are named for."""
    d = demux(_encode(port_anim, _delta_frames(), {}, {}, device="cpu"))
    assert [f.duration_ms for f in d.frames] == [40, 110, 70]   # merged
    d = demux(_encode(port_anim, _erase_frames(), {}, {}, device="cpu"))
    assert d.frames[1].dispose_background
    d = demux(_encode(port_anim, _blank_frames(), {}, {}, device="cpu"))
    assert d.frames[1].blend
    d = demux(_encode(port_anim, _key_frames(), {"kmax": 1}, {},
                      device="cpu"))
    assert all((f.x, f.y, f.blend) == (0, 0, False) for f in d.frames)
    data = _encode(port_anim, _delta_frames()[:1], {"loop_count": 5}, {},
                   device="cpu")
    assert not demux(data).has_animation
    d = demux(_encode(port_anim, _delta_frames(), {"allow_mixed": True}, {},
                      device="cpu"))
    assert d.num_frames == 3


def _pil_animation(frames, durations, **kw):
    imgs = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    imgs[0].save(buf, "WEBP", save_all=True, append_images=imgs[1:],
                 duration=durations, loop=0, **kw)
    return buf.getvalue()


PILLOW = {
    "lossless": lambda: _pil_animation(_key_frames(), [30] * 6,
                                       lossless=True, exact=True),
    "lossy": lambda: _pil_animation(_key_frames(), [30, 60, 30, 60, 30, 60],
                                    quality=70),
    "lossy_alpha": lambda: _pil_animation(_alpha_frames(), [20, 30, 40],
                                          quality=85),
    "lossless_alpha": lambda: _pil_animation(_alpha_frames(), [20, 30, 40],
                                             lossless=True),
    "mixed": lambda: _pil_animation(_key_frames(), [30] * 6,
                                    allow_mixed=True, quality=50),
    "still": lambda: _pil_animation(_key_frames()[:1], [30], quality=70),
}


@pytest.mark.parametrize("name", sorted(PILLOW))
def test_decode_animation_of_pillow_files(name):
    data = PILLOW[name]()
    got, d = _same_canvases(data)
    if name in ("lossless", "lossy", "mixed") and d.num_frames > 1:
        # opaque frames: Pillow's compositing agrees
        im = Image.open(io.BytesIO(data))
        for i, c in enumerate(got):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGBA")),
                                          c.rgba)


def test_decode_animation_of_the_ports_files():
    for case in ("defaults", "lossy", "dispose_background", "blanking",
                 "alpha_lossy", "kmax3_kmin1_lossy"):
        make, enc_kw, add_kw = CASES[case]
        data = _encode(port_anim, make(), enc_kw, add_kw, device="cpu")
        _same_canvases(data)


def test_decode_animation_lossless_round_trip():
    frames = _erase_frames()
    got, _ = port_anim.decode_animation(
        _encode(port_anim, frames, {}, {}, device="cpu"), device="cpu")
    for c, f in zip(got, frames):
        np.testing.assert_array_equal(c.rgba, f)


def test_frame_outside_the_canvas_raises_the_reference_class():
    """A frame larger than the declared canvas fails in both packages
    with the same exception class."""
    data = _pil_animation(_key_frames()[:3], [10] * 3, lossless=True)
    m = ref_mux.Mux.from_bytes(data)
    m.frames[0].x, m.frames[0].y = 8, 4      # the full-canvas keyframe
    m.canvas_width, m.canvas_height = 40, 24
    bad = m.assemble()
    with pytest.raises(Exception) as want:
        ref_anim.decode_animation(bad)
    with pytest.raises(Exception) as got:
        port_anim.decode_animation(bad, device="cpu")
    assert got.type.__name__ == want.type.__name__ == "ValueError"


@pytest.mark.parametrize("seed", range(4))
def test_blend_nonpremult_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (33, 17, 4), dtype=np.uint8)
    dst = rng.integers(0, 256, (33, 17, 4), dtype=np.uint8)
    pick = rng.random((33, 17))
    src[..., 3][pick < 0.2] = 0
    src[..., 3][pick > 0.8] = 255
    dst[..., 3][rng.random((33, 17)) < 0.2] = 0
    dst[..., 3][rng.random((33, 17)) < 0.2] = 255
    got = port_anim._blend_nonpremult(src, dst)
    np.testing.assert_array_equal(got, ref_anim._blend_nonpremult(src, dst))
    assert got.dtype == np.uint8
