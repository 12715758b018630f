"""PyTorch port: import boundary and device policy guards."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gowebp_tpu")


def _port_files():
    files = sorted((ROOT / "gowebp_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    """Without device="cpu" the entry point needs CUDA: on a host without
    it, it raises before any work instead of running on the CPU."""
    import gowebp_tpu_torch.ops.encode_pipeline as pipe
    from gowebp_tpu_torch import encode_rgba_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(pipe, "encode_hybrid_core",
                        lambda *a, **k: ran.append(1))
    im = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_rgba_batch([im, im])
    with pytest.raises(RuntimeError, match="CUDA"):
        pipe.encode_rgba_batch_pipelined([im])
    assert not ran


def test_decode_default_device_is_cuda_and_raises_without_it(monkeypatch):
    """decode_rgba_batch without device= needs CUDA too: without it, it
    raises before any host or device work."""
    import io

    from PIL import Image

    dec = importlib.import_module("gowebp_tpu_torch.decode")
    from gowebp_tpu_torch import decode_rgba_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(dec, "decode_vp8_symbols_batch",
                        lambda *a, **k: ran.append(1))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "WEBP")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_rgba_batch([buf.getvalue()])
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_rgba_batch([buf.getvalue()], device="cuda", device_out=True)
    assert not ran


def test_decode_host_backend_needs_cuda_too(monkeypatch):
    """recon_backend="host" without device= needs CUDA as the device
    backend does: without it, it raises before any host work."""
    import io

    from PIL import Image

    dec = importlib.import_module("gowebp_tpu_torch.decode")
    from gowebp_tpu_torch import decode_rgba_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("decode_vp8_symbols_batch", "decode_vp8l",
                 "recon_vp8_yuv_host"):
        monkeypatch.setattr(dec, name, lambda *a, **k: ran.append(1))
    datas = []
    for kw in ({}, {"lossless": True}):
        buf = io.BytesIO()
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "WEBP",
                                                             **kw)
        datas.append(buf.getvalue())
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_rgba_batch(datas, recon_backend="host")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_rgba_batch(datas, recon_backend="host", device_out=True)
    assert not ran


def test_boundary_scan_covers_the_decode_modules():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("entropy/bitio.py", "models/vp8/alpha.py",
                "models/vp8l/decoder.py", "models/vp8l/transforms_np.py",
                "decode.py"):
        assert f"gowebp_tpu_torch/{mod}" in names


def test_boundary_scan_covers_the_single_file_decode_modules():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("decode_options.py", "ops/kernels/vp8_recon.py",
                "container/riff.py", "models/vp8/decoder.py"):
        assert f"gowebp_tpu_torch/{mod}" in names


def test_boundary_scan_covers_the_single_image_encode_modules():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("encode.py", "stats.py", "utils/metrics.py",
                "entropy/huffman.py", "models/vp8l/encoder.py",
                "models/vp8l/near_lossless.py", "models/vp8/encoder.py"):
        assert f"gowebp_tpu_torch/{mod}" in names


@pytest.mark.parametrize("name", ["encode_rgba", "encode_yuv"])
def test_single_image_encode_default_device_is_cuda(monkeypatch, name):
    """encode_rgba and encode_yuv without device= need CUDA: without it,
    they raise before any work (no YUV conversion, no dense phase)."""
    import gowebp_tpu_torch
    from gowebp_tpu_torch.models.vp8 import encoder as enc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for fn in ("rgb_to_yuv420", "encode_vp8_frame", "encode_vp8_webp",
               "_pad_to_mb"):
        monkeypatch.setattr(enc, fn, lambda *a, **k: ran.append(1))
    call = getattr(gowebp_tpu_torch, name)
    args = ((np.zeros((16, 16, 4), np.uint8),) if name == "encode_rgba"
            else (np.zeros((16, 16), np.uint8), np.zeros((8, 8), np.uint8),
                  np.zeros((8, 8), np.uint8)))
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(*args, **kw)
    assert not ran


SINGLE_FILE_CALLS = ["decode", "decode_rgba", "decode_rgb", "decode_into",
                     "decode_yuv", "decode_yuva"]


@pytest.mark.parametrize("name", SINGLE_FILE_CALLS)
def test_single_file_decode_default_device_is_cuda(monkeypatch, name):
    """Every single-file decode call without device= needs CUDA: without
    it, it raises before any work, for lossy and lossless files alike."""
    import io

    from PIL import Image

    import gowebp_tpu_torch
    dec = importlib.import_module("gowebp_tpu_torch.decode")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for fn in ("decode_vp8_symbols", "decode_vp8l", "parse_riff"):
        monkeypatch.setattr(dec, fn, lambda *a, **k: ran.append(1))
    datas = []
    for kw in ({}, {"lossless": True}):
        buf = io.BytesIO()
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "WEBP",
                                                             **kw)
        datas.append(buf.getvalue())
    call = getattr(gowebp_tpu_torch, name)
    for data in datas:
        args = (data, np.zeros((16, 16, 4), np.uint8)) \
            if name == "decode_into" else (data,)
        with pytest.raises(RuntimeError, match="CUDA"):
            call(*args)
        with pytest.raises(RuntimeError, match="CUDA"):
            call(*args, device="cuda")
    assert not ran


def _opaque_mixed_batch():
    from gowebp_tpu_torch.utils.corpus import natural_image

    a = natural_image(33, 17, seed=1)
    return [np.dstack([a, np.full(a.shape[:2], 255, np.uint8)]),
            natural_image(64, 48, seed=2), natural_image(33, 17, seed=3),
            natural_image(33, 17, seed=4)]


@pytest.mark.parametrize("engine", ["hybrid", "wavefront", "openloop"])
def test_mixed_opaque_shapes_give_the_reference_bytes(engine):
    """A batch of mixed shapes and channel counts, all opaque, gives the
    reference's bytes (its per-image host encode), whatever engine."""
    import gowebp_tpu
    from gowebp_tpu_torch import encode_rgba_batch

    imgs = _opaque_mixed_batch()
    want = gowebp_tpu.encode_rgba_batch(imgs, quality=60.0, engine=engine)
    assert encode_rgba_batch(imgs, quality=60.0, device="cpu",
                             engine=engine) == want


@pytest.mark.parametrize("engine", ["hybrid", "wavefront", "openloop"])
def test_mixed_shapes_raise(engine):
    """A mixed batch with a non-opaque RGBA image (which raised
    UnsupportedFeature before the port had the single-image encode) gives
    the reference's bytes, its per-image encode_rgba with an ALPH chunk,
    whatever engine; the alpha is never dropped."""
    import gowebp_tpu
    from gowebp_tpu_torch import decode_rgba, encode_rgba_batch

    a = np.zeros((32, 32, 3), np.uint8)
    b = np.full((32, 48, 4), 255, np.uint8)
    b[3, 4, 3] = 7
    want = gowebp_tpu.encode_rgba_batch([a, b], quality=60.0, engine=engine)
    got = encode_rgba_batch([a, b], quality=60.0, device="cpu", engine=engine)
    assert got == want
    assert decode_rgba(got[1], device="cpu")[3, 4, 3] == 7


@pytest.mark.parametrize("case", ["quality_150", "quality_neg", "float32"])
def test_batch_encode_checks_its_inputs_where_the_reference_batch_does_not(
        case):
    """The port checks batch-encode inputs as the reference's encode_rgba
    does (gowebp_tpu/encode.py:36-40), not as its batch path: quality 150
    and float32 pixels, which the reference's batch path encodes, and
    quality -1, on which it raises TypeError, raise InvalidConfig or
    EncodeError here."""
    import gowebp_tpu
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.errors import EncodeError, InvalidConfig
    from gowebp_tpu_torch.utils.corpus import natural_image

    im = natural_image(17, 21, seed=5)
    imgs, kw = {"quality_150": ([im, im], {"quality": 150}),
                "quality_neg": ([im, im], {"quality": -1}),
                "float32": ([im.astype(np.float32)] * 2, {})}[case]
    if case == "quality_neg":
        with pytest.raises(TypeError):
            gowebp_tpu.encode_rgba_batch(imgs, **kw)
    else:
        assert gowebp_tpu.encode_rgba_batch(imgs, **kw)[0][:4] == b"RIFF"
    with pytest.raises(EncodeError if case == "float32" else InvalidConfig):
        encode_rgba_batch(imgs, device="cpu", **kw)


def test_kernel_wrappers_route_cpu_tensors_to_plain_versions():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    from gowebp_tpu_torch.models.vp8.encoder import _default_cost_tables
    from gowebp_tpu_torch.ops.kernels.i4_search import i4_search, t3_tables

    before = i4_search.launches
    S = 8
    t3 = t3_tables(tuple(torch.from_numpy(t.astype(np.int32))
                         for t in _default_cost_tables()))
    q5 = torch.tensor([[8192, 6553, 16, 20, 1600]] * S, dtype=torch.int32)
    mode, cost, rec = i4_search(torch.full((S, 13), 128, dtype=torch.int32),
                                torch.full((S, 16), 128, dtype=torch.int32),
                                q5, t3)
    assert i4_search.launches == before
    assert mode.shape == cost.shape == (S,) and rec.shape == (S, 16)
    assert torch.equal(mode, torch.zeros(S, dtype=torch.int32))


def test_cuda_build_needs_nvcc(monkeypatch, tmp_path):
    """A missing compiler raises instead of falling back."""
    from gowebp_tpu_torch.ops.kernels import cuda_build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has nvcc")
    with pytest.raises(cuda_build.KernelBuildError):
        cuda_build.nvcc()


def test_boundary_scan_covers_the_parallel_modules():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "parallel/shard.py",
                "ops/kernels/vp8l_inverse.py"):
        assert f"gowebp_tpu_torch/{mod}" in names


def test_parallel_default_device_is_cuda_and_raises_without_it(monkeypatch):
    """make_mesh and initialize without device= need CUDA: without it they
    raise before touching torch.distributed."""
    import torch.distributed as dist

    from gowebp_tpu_torch.parallel import distributed
    from gowebp_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, data=1, tile=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("localhost:1", 1, 0)
    assert not ran


@pytest.mark.parametrize("step", ["sharded_encode_plane_step",
                                  "sharded_wavefront_encode",
                                  "sharded_recon_frame",
                                  "sharded_recon_step",
                                  "sharded_lossless_inverse"])
def test_sharded_steps_on_a_cuda_mesh_raise_without_cuda(monkeypatch, step):
    """A rank whose mesh is CUDA and that finds no card raises before any
    work or exchange."""
    import types

    from gowebp_tpu_torch.parallel import shard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sent = []
    monkeypatch.setattr(shard, "send_halo", lambda *a: sent.append(1))
    monkeypatch.setattr(shard, "recv_halo", lambda *a: sent.append(1))
    mesh = types.SimpleNamespace(device_type="cuda")
    planes = [np.zeros((1, 16, 16), np.int32),
              np.zeros((1, 8, 8), np.int32), np.zeros((1, 8, 8), np.int32)]
    recon = [np.zeros((1, 1, 24, 16), np.int16), np.zeros((1, 1), np.int32),
             np.zeros((1, 1, 16), np.int32), np.zeros((1, 1), np.int32),
             np.zeros((1, 1, 1, 4), np.int32)]
    call = {
        "sharded_encode_plane_step": lambda f: f(mesh, *planes, quants={}),
        "sharded_wavefront_encode": lambda f: f(
            mesh, *planes, np.zeros((1, 1, 1), np.int32),
            np.ones((1, 4, 6), np.int32), (), try_i4=False),
        "sharded_recon_frame": lambda f: f(mesh, *recon, mb_w=1, mb_h=1,
                                           filter_type=2),
        "sharded_recon_step": lambda f: f(mesh, *recon, mb_w=1, mb_h=1,
                                          filter_type=2),
        "sharded_lossless_inverse": lambda f: f(
            mesh, np.zeros((1, 4, 4), np.uint32), np.zeros((1, 1), np.uint32),
            bits=2),
    }[step]
    with pytest.raises(RuntimeError, match="CUDA"):
        call(getattr(shard, step))
    assert not sent


def test_new_kernel_wrappers_route_cpu_tensors_to_plain_versions():
    """predictor_inverse and the halo and stripe forms run their plain
    versions on CPU tensors and count no kernel launch."""
    from gowebp_tpu_torch.ops.kernels import encode_plane as epm
    from gowebp_tpu_torch.ops.kernels.vp8_recon import (
        recon_filter_mb, recon_filter_mb_stripe)
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import predictor_inverse
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        wavefront_search, wavefront_search_stripe)

    counts = lambda: (predictor_inverse.launches, epm.encode_luma.launches,  # noqa: E731
                      epm.encode_chroma.launches, wavefront_search.launches,
                      recon_filter_mb.launches)
    before = counts()
    out = predictor_inverse(torch.zeros((2, 3, 5), dtype=torch.int32),
                            torch.zeros((1, 2), dtype=torch.int32), 2,
                            add_green=True)
    assert out.shape == (2, 3, 5) and out.dtype == torch.int32
    q = (8192, 12288, 6553, 14080)
    y = torch.zeros((1, 16, 16), dtype=torch.uint8)
    c = torch.zeros((1, 8, 8), dtype=torch.uint8)
    epm.encode_luma(y, q, q, halo=torch.zeros((1, 16), dtype=torch.uint8))
    epm.encode_chroma(c, c, q, halo=(torch.zeros((1, 8), dtype=torch.uint8),
                                     torch.zeros((1, 8), dtype=torch.uint8)))
    qs = torch.full((1, 4, 6), 20, dtype=torch.int32)
    wavefront_search_stripe(y, c, c, torch.zeros((1, 1, 1), dtype=torch.int32),
                            qs, None, None, try_i4=False, use_derr=True)
    coeffs = torch.zeros((1, 1, 24, 16), dtype=torch.int16)
    modes = torch.zeros((1, 1, 18), dtype=torch.uint8)
    recon_filter_mb_stripe(coeffs, modes, torch.zeros((1, 1, 1, 4),
                                                      dtype=torch.int16),
                           1, 1, 2)
    assert counts() == before


def test_boundary_scan_covers_the_container_and_cli_modules():
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("container/demux.py", "container/mux.py", "container/anim.py",
                "utils/bittrace.py", "utils/metrics.py", "__main__.py"):
        assert f"gowebp_tpu_torch/{mod}" in names


def _still(**kw):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "WEBP", **kw)
    return buf.getvalue()


def test_animation_default_device_is_cuda_and_raises_without_it(monkeypatch):
    """AnimationEncoder and decode_animation without device= need CUDA:
    without it they raise before any encode, demux or decode."""
    from gowebp_tpu_torch.container import anim
    dec = importlib.import_module("gowebp_tpu_torch.decode")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(anim, "_encode_candidate",
                        lambda *a, **k: ran.append(1))
    monkeypatch.setattr(anim, "demux", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(dec, "decode_rgba_batch",
                        lambda *a, **k: ran.append(1))
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            anim.AnimationEncoder(**kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            anim.decode_animation(_still(lossless=True), **kw)
    assert not ran


@pytest.mark.parametrize("cmd", ["encode", "decode"])
def test_cli_default_device_is_cuda_and_raises_without_it(monkeypatch,
                                                          tmp_path, cmd):
    """The CLI's encode and decode without --device need CUDA: in process
    they raise before any work; as a program they exit non-zero."""
    import os
    import subprocess
    import sys

    from PIL import Image

    import gowebp_tpu_torch.encode as enc_mod
    from gowebp_tpu_torch.__main__ import main
    dec = importlib.import_module("gowebp_tpu_torch.decode")

    src = tmp_path / ("in.png" if cmd == "encode" else "in.webp")
    if cmd == "encode":
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(src)
    else:
        src.write_bytes(_still())
    out = tmp_path / ("out.webp" if cmd == "encode" else "out.png")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(enc_mod, "_encode_lossless",
                        lambda *a, **k: ran.append(1))
    monkeypatch.setattr(dec, "_vp8_planes", lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([cmd, str(src), str(out)])
    assert not ran and not out.exists()
    r = subprocess.run([sys.executable, "-m", "gowebp_tpu_torch", cmd,
                        str(src), str(out)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not out.exists()
