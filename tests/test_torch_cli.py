"""PyTorch port: the command line (``python -m gowebp_tpu_torch``) run
in-process with ``--device cpu`` beside the JAX package's ``main``: the
same .webp bytes, PNG pixels, statistics and info JSON."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gowebp_tpu.__main__ import main as ref_main
from gowebp_tpu_torch.__main__ import main as port_main

from util import make_test_images

REPO = str(Path(__file__).resolve().parent.parent)
IMAGES = make_test_images()


def _png(tmp_path, arr, name="in.png"):
    path = tmp_path / name
    Image.fromarray(arr).save(path)
    return str(path)


def _webp(tmp_path, arr, name, **kw):
    path = tmp_path / name
    Image.fromarray(arr).save(path, "WEBP", **kw)
    return str(path)


@pytest.mark.parametrize("flags", [
    [],
    ["--quality", "40", "--method", "6", "--segments", "2"],
    ["--partitions", "2", "--autofilter", "--sharp-yuv"],
    ["--target-size", "900"],
    ["--lossless"],
    ["--lossless", "--quality", "90", "--method", "2"],
    ["--lossless", "--near-lossless", "60"],
    ["--near-lossless", "40"],
])
def test_encode_gives_the_reference_bytes(tmp_path, flags, capsys):
    src = _png(tmp_path, IMAGES["photo"][:48, :56, :3].copy())
    a, b = str(tmp_path / "ref.webp"), str(tmp_path / "port.webp")
    assert ref_main(["encode", src, a, *flags, "-v"]) == 0
    ref_err = capsys.readouterr().err
    assert port_main(["encode", src, b, *flags, "-v", "--device", "cpu"]) == 0
    port_err = capsys.readouterr().err
    assert Path(b).read_bytes() == Path(a).read_bytes()
    # -v: the size line and the EncodeStats fields, the reference's
    assert port_err.replace("port.webp", "ref.webp") == ref_err


def test_encode_rgba_png_gives_the_reference_bytes(tmp_path):
    src = _png(tmp_path, IMAGES["alpha_noise"])
    for flags in ([], ["--lossless"]):
        a, b = tmp_path / "a.webp", tmp_path / "b.webp"
        assert ref_main(["encode", src, str(a), *flags]) == 0
        assert port_main(["encode", src, str(b), *flags,
                          "--device", "cpu"]) == 0
        assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("flags", [
    [],
    ["--crop", "3", "5", "20", "17"],
    ["--scale", "31", "22"],
    ["--crop", "2", "2", "20", "18", "--scale", "15", "40"],
    ["--mode", "RGB"],
    ["--mode", "BGRA"],
    ["--mode", "rgbA"],
    ["--no-fancy"],
    ["--no-filter"],
    ["--no-fancy", "--no-filter", "--mode", "RGB"],
])
@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless"])
def test_decode_gives_the_reference_pixels(tmp_path, flags, kind):
    arr = {"lossy": IMAGES["photo"][:40, :44, :3].copy(),
           "lossy_alpha": IMAGES["alpha_noise"],
           "lossless": IMAGES["palette4"]}[kind]
    src = _webp(tmp_path, arr, "in.webp", lossless=kind == "lossless",
                quality=70)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    assert ref_main(["decode", src, str(a), *flags]) == 0
    assert port_main(["decode", src, str(b), *flags, "--device", "cpu"]) == 0
    want = np.asarray(Image.open(a))
    got = np.asarray(Image.open(b))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _animation(tmp_path):
    frames = []
    rng = np.random.default_rng(4)
    for _ in range(3):
        f = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
        f[..., 3] = 255
        frames.append(Image.fromarray(f))
    path = tmp_path / "anim.webp"
    frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:],
                   duration=[10, 20, 30], loop=4, lossless=True,
                   icc_profile=b"\0" * 20, exif=b"Exif\0\0ab")
    return str(path)


def _info(main, path, capsys):
    assert main(["info", path]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless",
                                  "animated"])
def test_info_gives_the_reference_json(tmp_path, kind, capsys):
    if kind == "animated":
        path = _animation(tmp_path)
    else:
        arr = {"lossy": IMAGES["photo"][..., :3].copy(),
               "lossy_alpha": IMAGES["alpha_noise"],
               "lossless": IMAGES["gradient"]}[kind]
        path = _webp(tmp_path, arr, "in.webp",
                     lossless=kind == "lossless")
    want = _info(ref_main, path, capsys)
    assert _info(port_main, path, capsys) == want
    if kind == "animated":
        assert (want["frames"], want["loop_count"],
                want["has_animation"]) == (3, 4, True)
        assert want["metadata"] == ["icc", "exif"]


def test_encode_and_decode_errors_raise_the_reference_class(tmp_path):
    bad = tmp_path / "bad.webp"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WEBP")
    src = _png(tmp_path, IMAGES["solid"])
    for argv in (["decode", str(bad), str(tmp_path / "o.png")],
                 ["encode", src, str(tmp_path / "o.webp"), "--quality",
                  "150"]):
        with pytest.raises(Exception) as want:
            ref_main(argv)
        with pytest.raises(Exception) as got:
            port_main([*argv, "--device", "cpu"])
        assert got.type.__name__ == want.type.__name__


def test_module_runs_as_a_program(tmp_path):
    """``python -m gowebp_tpu_torch info`` in a process of its own."""
    path = _webp(tmp_path, IMAGES["gradient"], "g.webp", lossless=True)
    r = subprocess.run([sys.executable, "-m", "gowebp_tpu_torch", "info",
                        path], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    assert (info["width"], info["height"], info["format"]) == (48, 64,
                                                               "lossless")
    r = subprocess.run([sys.executable, "-m", "gowebp_tpu_torch", "encode",
                        "--help"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0
    assert "--device" in r.stdout and "--near-lossless" in r.stdout
