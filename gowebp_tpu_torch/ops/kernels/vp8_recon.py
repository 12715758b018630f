"""The lossy decode's reconstruction and loop filter: the Hopper kernel,
its binding and its plain version.

``recon_filter_mb`` turns dequantized coefficients, modes and filter
parameters into the reconstructed, deblocked uint8 planes: residual iDCT,
intra prediction and the in-loop filter over the MB wavefront, each MB
filtered right after its recon.  On a CUDA tensor it launches the one
kernel in ``vp8_recon.cu`` (replacing the XLA ``recon_wavefront`` and
``loop_filter_wavefront`` of gowebp_tpu/ops/vp8_recon_jax.py); on a CPU
tensor it runs its plain version, ``recon_mb_plain`` followed by
``loop_filter_mb_plain`` (the torch loops of ops/vp8_recon.py).

Layout:
  coeffs   (B, N, 24, 16) int16 dequantized raster coefficients,
           N = mb_h * mb_w
  modes    (B, N, 18) uint8: is_i4, uvmode, imodes x16 (``pack_modes``)
  fparams  (B, N, 4) or (B, mb_h, mb_w, 4) int: limit, ilevel, hev_t, inner
  y        (B, 16 mb_h, 16 mb_w) uint8; u, v (B, 8 mb_h, 8 mb_w) uint8
"""

from __future__ import annotations

import ctypes

import torch

from .. import vp8_recon as plain
from .cuda_build import CudaLibrary, check_tensor, stream_handle

U8, I16, I32 = torch.uint8, torch.int16, torch.int32
MODE_BYTES = 18


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.recon_filter_mb_launch.restype = ctypes.c_int
    lib.recon_filter_mb_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                           p]


LIBRARY = CudaLibrary("vp8_recon.cu", _configure)


def pack_modes(is_i4, imodes, uvmode):
    """(B, N) is_i4, (B, N, 16) imodes, (B, N) uvmode → the kernel's
    (B, N, 18) uint8 modes."""
    return torch.cat([is_i4[..., None], uvmode[..., None], imodes],
                     dim=-1).to(U8).contiguous()


def _check_recon(coeffs, modes, mb_w: int, mb_h: int) -> None:
    if mb_w <= 0 or mb_h <= 0:
        raise ValueError(f"recon_filter_mb: bad MB grid {mb_w}x{mb_h}")
    N = mb_w * mb_h
    if coeffs.dim() != 4 or coeffs.shape[1:] != (N, 24, 16):
        raise ValueError(f"recon_filter_mb: coeffs must be (B, {N}, 24, 16), "
                         f"got {tuple(coeffs.shape)}")
    if modes.shape != (coeffs.shape[0], N, MODE_BYTES):
        raise ValueError(f"recon_filter_mb: modes must be (B, {N}, "
                         f"{MODE_BYTES}), got {tuple(modes.shape)}")


def _planes(B: int, mb_w: int, mb_h: int, dev):
    return (torch.empty((B, 16 * mb_h, 16 * mb_w), dtype=U8, device=dev),
            torch.empty((B, 8 * mb_h, 8 * mb_w), dtype=U8, device=dev),
            torch.empty((B, 8 * mb_h, 8 * mb_w), dtype=U8, device=dev))


def _sync(rows: int, dev):
    """Zeroed progress counters (one per MB row) and the row ticket."""
    return torch.zeros(rows + 1, dtype=I32, device=dev)


def recon_mb_plain(coeffs, modes, mb_w: int, mb_h: int):
    """The plain version's first half (any device): the residual iDCT and
    ops/vp8_recon.py's ``recon_wavefront`` → the unfiltered (Y, U, V)."""
    _check_recon(coeffs, modes, mb_w, mb_h)
    dg = plain.Diagonals(mb_w, mb_h, coeffs.device)
    m = modes.to(I32)
    PY, PC = plain.recon_wavefront(*plain.residual_blocks(coeffs.to(I32)),
                                   m[..., 0], m[..., 2:], m[..., 1], dg)
    return plain.crop_planes(PY, PC, mb_w)


def _check_fparams(fparams, B: int, mb_w: int, mb_h: int,
                   filter_type: int) -> None:
    if filter_type not in (0, 1, 2):
        raise ValueError(f"recon_filter_mb: filter_type must be 0, 1 or 2, "
                         f"got {filter_type}")
    if fparams.numel() != B * mb_h * mb_w * 4 or fparams.shape[-1] != 4:
        raise ValueError(f"recon_filter_mb: fparams {tuple(fparams.shape)} "
                         f"is not (B, {mb_h}, {mb_w}, 4)")


def _check_filter(y, u, v, fparams, mb_w: int, mb_h: int, filter_type: int):
    B = y.shape[0]
    if y.shape != (B, 16 * mb_h, 16 * mb_w):
        raise ValueError(f"loop_filter_mb_plain: y {tuple(y.shape)} is not "
                         f"(B, {16 * mb_h}, {16 * mb_w})")
    for name, c in (("u", u), ("v", v)):
        if c.shape != (B, 8 * mb_h, 8 * mb_w):
            raise ValueError(f"loop_filter_mb_plain: {name} "
                             f"{tuple(c.shape)} is not (B, {8 * mb_h}, "
                             f"{8 * mb_w})")
    _check_fparams(fparams, B, mb_w, mb_h, filter_type)


def loop_filter_mb_plain(y, u, v, fparams, mb_w: int, mb_h: int,
                         filter_type: int):
    """The plain version's second half (any device): ops/vp8_recon.py's
    ``loop_filter_wavefront`` on bordered copies, written back into the
    planes.  Returns (y, u, v)."""
    _check_filter(y, u, v, fparams, mb_w, mb_h, filter_type)
    if filter_type == 0:
        return y, u, v
    B, P, dev = y.shape[0], plain.PAD, y.device
    PY = plain._bordered(B, 16 * mb_h, 16 * mb_w, dev)
    PC = plain._bordered(2 * B, 8 * mb_h, 8 * mb_w, dev)
    PY[:, P:, P:P + 16 * mb_w] = y
    PC[:B, P:, P:P + 8 * mb_w] = u
    PC[B:, P:, P:P + 8 * mb_w] = v
    plain.loop_filter_wavefront(
        PY, PC, fparams.reshape(B, mb_h, mb_w, 4),
        plain.Diagonals(mb_w, mb_h, dev), filter_type)
    Y, U, V = plain.crop_planes(PY, PC, mb_w)
    y.copy_(Y)
    u.copy_(U)
    v.copy_(V)
    return y, u, v


def _check(coeffs, modes, fparams, mb_w: int, mb_h: int,
           filter_type: int) -> None:
    _check_recon(coeffs, modes, mb_w, mb_h)
    _check_fparams(fparams, coeffs.shape[0], mb_w, mb_h, filter_type)


def recon_filter_mb_plain(coeffs, modes, fparams, mb_w: int, mb_h: int,
                          filter_type: int):
    """Plain torch version of the kernel (any device): the recon, then the
    filter over the whole frame → (Y, U, V) uint8 planes."""
    _check(coeffs, modes, fparams, mb_w, mb_h, filter_type)
    return loop_filter_mb_plain(*recon_mb_plain(coeffs, modes, mb_w, mb_h),
                                fparams, mb_w, mb_h, filter_type)


def recon_filter_mb(coeffs, modes, fparams, mb_w: int, mb_h: int,
                    filter_type: int):
    """Kernel on a CUDA tensor, plain version on a CPU tensor → the
    filtered (Y, U, V) uint8 planes.  ``filter_type`` 0 filters nothing.
    ``recon_filter_mb.launches`` counts kernel launches (one per call on
    CUDA)."""
    dev = coeffs.device
    if dev.type == "cpu":
        return recon_filter_mb_plain(coeffs, modes, fparams, mb_w, mb_h,
                                     filter_type)
    if dev.type != "cuda":
        raise ValueError(f"recon_filter_mb: unsupported device {dev}")
    _check(coeffs, modes, fparams, mb_w, mb_h, filter_type)
    B = coeffs.shape[0]
    check_tensor("coeffs", coeffs, I16, coeffs.shape, dev)
    check_tensor("modes", modes, U8, modes.shape, dev)
    fp = fparams.reshape(B, mb_h * mb_w, 4).to(I16).contiguous()
    check_tensor("fparams", fp, I16, fp.shape, dev)
    lib = LIBRARY.load()
    y, u, v = _planes(B, mb_w, mb_h, dev)
    # top samples: each MB row's unfiltered bottom row, Y then U then V
    ts = torch.empty(B * mb_h * 32 * mb_w, dtype=U8, device=dev)
    sync = _sync(B * mb_h, dev)
    err = lib.recon_filter_mb_launch(
        coeffs.data_ptr(), modes.data_ptr(), fp.data_ptr(), y.data_ptr(),
        u.data_ptr(), v.data_ptr(), ts.data_ptr(), sync.data_ptr(), B, mb_h,
        mb_w, int(filter_type), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"recon_filter_mb kernel launch failed: CUDA error {err}")
    recon_filter_mb.launches += 1
    return y, u, v


recon_filter_mb.launches = 0

__all__ = ["LIBRARY", "loop_filter_mb_plain", "pack_modes", "recon_filter_mb",
           "recon_filter_mb_plain", "recon_mb_plain"]
