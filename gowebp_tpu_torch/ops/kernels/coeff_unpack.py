"""The batch decode's sparse coefficient unpack: the Hopper kernel, its
binding and its plain version.

``unpack_coeffs`` turns the packed wire layout of ops/coeff_pack.py
(``pack_coeffs``), as device tensors, into the dense (B, N, 24, 16) int16
raster coefficients that ``recon_filter_mb`` reads.  On CUDA tensors it
launches the one kernel of ``coeff_unpack.cu`` (replacing the XLA
``unpack_coeffs`` of gowebp_tpu/ops/coeff_pack.py); on CPU tensors it
runs ``unpack_coeffs_plain``.

Layout (the dict's keys; T tail rows, E exception rows):
  lv8       (B, N, 24, K) int8 zigzag levels, K in {4, 8, 16}
  dc16      (B, N, 16) int16 luma DC lanes of the i16 MBs
  tail_idx  (T,) int32 flat block index (b * N + n) * 24 + block
  tail_val  (T, max(1, 16 - K)) int8 levels K..15
  exc_idx   (E,) int32 flat block index
  exc_val   (E, 16) int16 raw zigzag coefficients
  seg       (B, N) uint8 segment id; is_i4 (B, N) uint8
  qmat      (B, 4, 6) int32 rows (y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac)
A table index is read as the reference's scatter reads it: a negative
one counts from the end, and one outside the B * N * 24 blocks then is
skipped (``mode="drop"``); a segment id above 3 takes segment 0's row.

The kernel takes its tables in block order (``in_block_order``): each
CTA of ``BLOCKS_PER_CTA`` blocks finds its rows by searching the tables.
The packs emit them so (one pass in block order, images in order), and
so are the reference's padded tables.  The kernel checks the order as it
reads the rows and traps on a table out of order: the error shows at the
caller's next synchronizing call (``torch.cuda.synchronize()``, a copy
to the host), as a CUDA launch failure.  ``unpack_coeffs_plain`` takes
the rows in any order, as the reference's scatter does.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_tensor, stream_handle

I16, I32 = torch.int16, torch.int32
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
KEYS = ("lv8", "dc16", "tail_idx", "tail_val", "exc_idx", "exc_val", "seg",
        "is_i4", "qmat")


# Blocks a CTA of the kernel owns (kThreads x kPer in coeff_unpack.cu).
BLOCKS_PER_CTA = 768


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.unpack_coeffs_launch.restype = ctypes.c_int
    lib.unpack_coeffs_launch.argtypes = [p, p, p, p, i, p, p, i, p, p, p, i,
                                         i, i, p, p]
    lib.unpack_coeffs_kernel_launches.restype = ctypes.c_ulonglong
    lib.unpack_coeffs_kernel_launches.argtypes = []


LIBRARY = CudaLibrary("coeff_unpack.cu", _configure)


def _shapes(packed) -> tuple[int, int, int]:
    """(B, N, K), after checking every array's dtype and shape."""
    missing = [k for k in KEYS if k not in packed]
    if missing:
        raise ValueError(f"unpack_coeffs: packed lacks {missing}")
    lv8 = packed["lv8"]
    if lv8.dim() != 4 or lv8.shape[2] != 24 or lv8.shape[3] not in (4, 8, 16):
        raise ValueError(f"unpack_coeffs: lv8 must be (B, N, 24, 4|8|16), "
                         f"got {tuple(lv8.shape)}")
    B, N, _, K = lv8.shape
    T, E = packed["tail_idx"].shape[0], packed["exc_idx"].shape[0]
    want = {"lv8": (torch.int8, (B, N, 24, K)),
            "dc16": (I16, (B, N, 16)),
            "tail_idx": (I32, (T,)),
            "tail_val": (torch.int8, (T, max(1, 16 - K))),
            "exc_idx": (I32, (E,)),
            "exc_val": (I16, (E, 16)),
            "seg": (torch.uint8, (B, N)),
            "is_i4": (torch.uint8, (B, N)),
            "qmat": (I32, (B, 4, 6))}
    for k, (dtype, shape) in want.items():
        t = packed[k]
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"unpack_coeffs: {k} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if B * N * 24 >= 2 ** 31:
        raise ValueError(f"unpack_coeffs: {B * N * 24} blocks, the kernel "
                         f"takes under 2^31")
    return B, N, K


def _wrapped(idx, nblocks: int):
    """Table indices as block numbers: negative ones count from the end;
    -1 where the block does not exist."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + nblocks, idx)
    return torch.where((idx >= 0) & (idx < nblocks), idx, -1)


def in_block_order(idx, nblocks: int) -> bool:
    """The kernel's contract for a table's indices: keys (the block an
    index names as ``_wrapped`` reads it, ``nblocks`` for a dropped row)
    strictly increasing, so dropped rows come after every valid one."""
    key = _wrapped(idx, nblocks)
    key = torch.where(key < 0, nblocks, key)
    step = key[1:] - key[:-1]
    return bool(((step > 0) | (key[1:] == nblocks)).all())


def unpack_coeffs_plain(packed):
    """Plain torch version of the kernel (any device), in the reference's
    order: tails into the levels, the multiply, the i16 DC lanes, the
    exception rows, zigzag to raster."""
    B, N, K = _shapes(packed)
    dev = packed["lv8"].device
    nblocks = B * N * 24
    lv = torch.zeros((nblocks, 16), dtype=I32, device=dev)
    lv[:, :K] = packed["lv8"].reshape(nblocks, K).to(I32)
    if K < 16:
        idx = _wrapped(packed["tail_idx"], nblocks)
        keep = idx >= 0
        lv[idx[keep], K:] = packed["tail_val"][keep].to(I32)
    seg = packed["seg"].long()
    seg = torch.where(seg < 4, seg, 0)
    rows = packed["qmat"].to(I32)[torch.arange(B, device=dev)[:, None], seg]
    luma = (torch.arange(24, device=dev) < 16)[None, None, :]
    q_dc = torch.where(luma, rows[..., 0:1], rows[..., 4:5])
    q_ac = torch.where(luma, rows[..., 1:2], rows[..., 5:6])
    pos0 = torch.arange(16, device=dev) == 0
    q = torch.where(pos0, q_dc[..., None], q_ac[..., None])
    zz = lv.reshape(B, N, 24, 16) * q
    i16 = (packed["is_i4"] == 0)[:, :, None]
    zz[:, :, :16, 0] = torch.where(i16, packed["dc16"].to(I32),
                                   zz[:, :, :16, 0])
    flat = zz.reshape(nblocks, 16)
    idx = _wrapped(packed["exc_idx"], nblocks)
    keep = idx >= 0
    flat[idx[keep]] = packed["exc_val"][keep].to(I32)
    raster = torch.empty_like(zz)
    raster[..., list(ZIGZAG)] = zz
    return raster.to(I16)


def unpack_coeffs(packed):
    """Kernel on CUDA tensors, plain version on CPU tensors → (B, N, 24,
    16) int16 raster coefficients.  ``unpack_coeffs.launches`` counts the
    kernel's launches, one a call on CUDA (none for no blocks).  On CUDA
    the tables must be in block order (``in_block_order``; the kernel
    traps otherwise, see the module's note)."""
    dev = packed["lv8"].device
    if dev.type == "cpu":
        return unpack_coeffs_plain(packed)
    if dev.type != "cuda":
        raise ValueError(f"unpack_coeffs: unsupported device {dev}")
    B, N, K = _shapes(packed)
    for k in KEYS:
        check_tensor(k, packed[k], packed[k].dtype, packed[k].shape, dev)
    lib = LIBRARY.load()
    out = torch.empty((B, N, 24, 16), dtype=I16, device=dev)
    if out.numel() == 0:
        return out
    ptr = {k: packed[k].data_ptr() for k in KEYS}
    err = lib.unpack_coeffs_launch(
        ptr["lv8"], ptr["dc16"], ptr["tail_idx"], ptr["tail_val"],
        packed["tail_idx"].shape[0], ptr["exc_idx"], ptr["exc_val"],
        packed["exc_idx"].shape[0], ptr["seg"], ptr["is_i4"], ptr["qmat"],
        B, N, K, out.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"unpack_coeffs kernel launch failed: CUDA error {err}")
    unpack_coeffs.launches += 1
    return out


unpack_coeffs.launches = 0

__all__ = ["BLOCKS_PER_CTA", "LIBRARY", "in_block_order", "unpack_coeffs",
           "unpack_coeffs_plain"]
