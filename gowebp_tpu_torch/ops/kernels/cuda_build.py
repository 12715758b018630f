"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each ``*.cu`` in this directory compiles on its own (with the shared
``*.cuh`` headers) into ``gowebp_tpu_torch/_build/lib<name>_<hash>.so``
for ``sm_90a``, at first use.  The libraries expose plain ``extern "C"``
launchers that take raw device pointers and a CUDA stream, return the
CUDA error code of the launch, and allocate nothing.  A missing nvcc or
a failed compile raises; nothing falls back.

Nothing here runs at import: the CPU tests import every module on a
host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ...tracing import count

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parent.parent / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")


class CudaLibrary:
    """One ``.cu`` source → one shared library, built and loaded lazily.

    ``configure(lib)`` declares the launchers' ctypes signatures.
    ``ptxas_log`` keeps nvcc's register/shared-memory report of the last
    build made by this process.
    """

    def __init__(self, source: str, configure):
        self.source = KERNEL_DIR / source
        self._configure = configure
        self._lock = threading.Lock()
        self._lib = None
        self.ptxas_log = ""

    def _so_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in [self.source] + sorted(KERNEL_DIR.glob("*.cuh")):
            h.update(p.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this source; returns (Popen, tmp, so) or None if
        the library is already built."""
        so = self._so_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        return proc, tmp, so

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, so = started
        out, _ = proc.communicate()
        self.ptxas_log = out.decode(errors="replace")
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {self.source.name}:\n{self.ptxas_log[-6000:]}")
        tmp.replace(so)

    def load(self):
        """The loaded library; builds it first if needed.  Building or
        opening it counts one ``kernels.loads`` (tracing.py)."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self._so_path()))
                self._configure(lib)
                self._lib = lib
                count("kernels.loads")
        return self._lib


def build_all(libraries) -> None:
    """Compile every library not built yet, one nvcc each, all at once."""
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, s in started:
        try:
            lib.finish_build(s)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))
    for lib in libraries:
        lib.load()


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the kernels take raw pointers)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["CudaLibrary", "KernelBuildError", "build_all", "check_tensor",
           "nvcc", "stream_handle"]
