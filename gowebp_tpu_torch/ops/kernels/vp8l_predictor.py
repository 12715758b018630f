"""The VP8L encoder's per-tile predictor chooser: the Hopper kernel, its
binding and its plain version.

``predictor_search_entropy(argb, bits, refine_iters)`` (see
ops/lossless.py for what it computes) on a CUDA tensor launches
``vp8l_predictor.cu`` (replacing the XLA function
gowebp_tpu/ops/lossless_jax.py:269 ``predictor_search_entropy``): one
launch scores stage 1, then each refinement round downloads the picks'
residual histogram and mode counts (4 KB), builds the round's table on
the host in float64 (ops/lossless.py ``refine_table``), uploads it and
launches again; a round in which no tile changed ends the rounds early
(a fixed point: every later round would pick the same modes).  Stage 1's
constant table is uploaded once a device (``stage1_device_table``).  On
a CPU tensor it runs ``predictor_search_entropy_plain``, the same
integer scores in torch.

Layout:
  argb   (H, W) int32, the ARGB words' bits
  modes  (th, tw) int32 out, th = ceil(H / 2^bits), tw = ceil(W / 2^bits)
  acc    int32 scratch: the picks' residual histogram (1024 bins), their
         mode counts (14) and the tiles that changed (1)
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .cuda_build import CudaLibrary, check_tensor, stream_handle

I32, I64 = torch.int32, torch.int64
ACC_WORDS = 1024 + 14 + 1


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vp8l_predictor_launch.restype = ctypes.c_int
    lib.vp8l_predictor_launch.argtypes = [p, i, i, i, p, i, p, p, p]


LIBRARY = CudaLibrary("vp8l_predictor.cu", _configure)
_count_lock = threading.Lock()
_table_lock = threading.Lock()
_tables: dict = {}               # device index -> stage 1's table on it


def stage1_kernel_table() -> np.ndarray:
    """Stage 1's int64 table in the kernel's layout: ops/lossless.py
    ``stage1_table`` (n log2 n for n in 0..1024, the 256 byte biases),
    then the first differences nlogn(n + 1) - nlogn(n), n in 0..1023, of
    those same integers (so the kernel's telescoping sums are exact)."""
    from .. import lossless as L

    tab = L.stage1_table()
    return np.concatenate([tab, np.diff(tab[:L.MAX_COUNT + 1])])


def _index(dev) -> int:
    dev = torch.device(dev)
    return torch.cuda.current_device() if dev.index is None else dev.index


def stage1_device_table(dev) -> torch.Tensor:
    """Stage 1's table on CUDA device ``dev``, uploaded at its first use
    and kept (``predictor_search_entropy.table_uploads`` counts the
    uploads)."""
    i = _index(dev)
    with _table_lock:
        tab = _tables.get(i)
        if tab is None:
            tab = torch.from_numpy(stage1_kernel_table()).to(
                torch.device("cuda", i))
            torch.cuda.current_stream(i).synchronize()  # any stream may read
            _tables[i] = tab
            _count("table_uploads")
    return tab


def _grid(h: int, w: int, bits: int):
    return (h + (1 << bits) - 1) >> bits, (w + (1 << bits) - 1) >> bits


def predictor_search_entropy_plain(argb: torch.Tensor, bits: int,
                                   refine_iters: int = 4) -> torch.Tensor:
    """Plain torch version of the kernel (any device): every mode's
    residual bytes, per-tile histograms by ``bincount``, the integer
    scores of ops/lossless.py's tables, ``argmin`` (the lowest mode on a
    tie) → the (th, tw) int32 mode map."""
    from .. import lossless as L

    L.check_search(argb, bits, refine_iters)
    dev = argb.device
    h, w = argb.shape
    th, tw = _grid(h, w, bits)
    T = th * tw
    x = L.to_words(argb)
    tile = ((torch.arange(h, device=dev) >> bits)[:, None] * tw
            + (torch.arange(w, device=dev) >> bits)[None, :]).reshape(-1)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)[:, None]
    chan = torch.arange(4, device=dev)[:, None] * 256
    # (14, 4, H*W): each mode's residual byte of each channel, as its bin
    bins = torch.stack([
        ((L._sub_pixels(x, L.predict_plane(x, m)).reshape(1, -1) >> shifts)
         & 0xFF) + chan for m in range(L.NUM_MODES)]).to(torch.int16)

    tab = torch.from_numpy(L.stage1_table()).to(dev)
    nlogn, bias = tab[:L.MAX_COUNT + 1], tab[L.MAX_COUNT + 1:].repeat(4)
    npx = torch.bincount(tile, minlength=T)
    scores = torch.empty((L.NUM_MODES, T), dtype=I64, device=dev)
    for m in range(L.NUM_MODES):
        keys = (tile[None, :] * L.BINS + bins[m]).reshape(-1)
        hist = torch.bincount(keys, minlength=T * L.BINS).reshape(T, L.BINS)
        scores[m] = (4 * nlogn[npx] + (hist * bias).sum(1)
                     - nlogn[hist].sum(1))
    modes = scores.argmin(0)

    pix = torch.arange(h * w, device=dev)
    for _ in range(refine_iters):
        chosen = bins[modes[tile], :, pix].to(I64)           # (H*W, 4)
        glob = torch.bincount(chosen.reshape(-1), minlength=L.BINS)
        mcount = torch.bincount(modes, minlength=L.NUM_MODES)
        q = torch.from_numpy(L.refine_table(glob.cpu().numpy(),
                                            mcount.cpu().numpy(), T)).to(dev)
        for m in range(L.NUM_MODES):
            per_px = q[bins[m].to(I64)].sum(0)
            scores[m] = torch.zeros(T, dtype=I64, device=dev).index_add_(
                0, tile, per_px) + q[L.BINS + m]
        new = scores.argmin(0)
        if torch.equal(new, modes):
            break
        modes = new
    return modes.reshape(th, tw).to(I32)


def _count(attr: str) -> None:
    with _count_lock:
        setattr(predictor_search_entropy, attr,
                getattr(predictor_search_entropy, attr) + 1)


def predictor_search_entropy(argb: torch.Tensor, bits: int,
                             refine_iters: int = 4) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version on a CPU tensor → the (th,
    tw) int32 mode map.  ``predictor_search_entropy.launches`` counts
    kernel launches (1 + the refinement rounds run, a call on CUDA) and
    ``.calls`` the calls on CUDA; both under a lock, since the photo
    path calls from a thread pool."""
    from .. import lossless as L

    dev = argb.device
    if dev.type == "cpu":
        return predictor_search_entropy_plain(argb, bits, refine_iters)
    if dev.type != "cuda":
        raise ValueError(f"predictor_search_entropy: unsupported device {dev}")
    L.check_search(argb, bits, refine_iters)
    check_tensor("argb", argb, I32, argb.shape, dev)
    lib = LIBRARY.load()
    h, w = argb.shape
    th, tw = _grid(h, w, bits)
    modes = torch.empty((th, tw), dtype=I32, device=dev)
    acc = torch.empty(ACC_WORDS, dtype=I32, device=dev)

    def launch(tab: torch.Tensor, refine: int) -> None:
        err = lib.vp8l_predictor_launch(
            argb.data_ptr(), h, w, bits, tab.data_ptr(), refine,
            modes.data_ptr(), acc.data_ptr(), stream_handle(dev))
        if err != 0:
            raise RuntimeError(f"predictor_search_entropy kernel launch "
                               f"failed: CUDA error {err}")
        _count("launches")

    launch(stage1_device_table(dev), 0)
    for r in range(refine_iters):
        a = acc.cpu().numpy()
        if r and a[-1] == 0:         # no tile changed: a fixed point
            break
        tab = L.refine_table(a[:L.BINS], a[L.BINS:L.BINS + L.NUM_MODES],
                             th * tw)
        launch(torch.from_numpy(tab).to(dev), 1)
    _count("calls")
    return modes


predictor_search_entropy.launches = 0
predictor_search_entropy.calls = 0
predictor_search_entropy.table_uploads = 0

__all__ = ["ACC_WORDS", "LIBRARY", "predictor_search_entropy",
           "predictor_search_entropy_plain", "stage1_device_table",
           "stage1_kernel_table"]
