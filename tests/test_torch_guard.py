"""PyTorch port: import boundary and device policy guards."""

import ast
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

    import gowebp_tpu_torch.decode as dec
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

    import gowebp_tpu_torch.decode as dec
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


def test_mixed_shapes_raise():
    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.errors import EncodeError

    a = np.zeros((32, 32, 3), np.uint8)
    b = np.zeros((32, 48, 3), np.uint8)
    with pytest.raises(EncodeError, match="shape"):
        encode_rgba_batch([a, b], device="cpu")


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
