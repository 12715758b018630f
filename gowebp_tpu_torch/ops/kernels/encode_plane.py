"""Open-loop luma and chroma plane encode: the Hopper kernels, their
binding and their plain versions.

``encode_luma`` and ``encode_chroma`` run the open-loop engine's dense
work for every macroblock at once: the DC/TM/VE/HE SSE mode search with
prediction context read from the source plane, the residual FDCT and
the quantization; ``encode_luma`` also runs the Y2 path (the WHT of each
MB's 16 DC coefficients and its quantization).  On a CUDA tensor they
launch the kernels in ``encode_plane.cu`` (replacing the TPU kernels
``_run_luma`` and ``_run_chroma`` of gowebp_tpu/ops/pallas/encode_plane.py,
and, for the Y2 path, the XLA ops around the first); on a CPU tensor they
run ``encode_luma_plain`` / ``encode_chroma_plain``, the same arithmetic
as vectorised torch ops.

Layout:
  y        (B, 16*mh, 16*mw) uint8 MB-padded luma plane
  u, v     (B, 8*mh, 8*mw) uint8 chroma planes
           (rows contiguous; any batch stride, so views of one wire
           buffer need no copy)
  quants   (iq_dc, bias_dc, iq_ac, bias_ac) ints, iq = (1 << 17) // q;
           luma takes the Y1 and the Y2 quantizers, chroma the UV ones
Outputs, macroblock-major as the emitter reads them:
  encode_luma   → ymode (B, mh, mw) uint8; y_levels (B, mh, mw, 16, 16)
                  int16 zigzag, DC slot zeroed (Y1); y2_levels
                  (B, mh, mw, 16) int16 zigzag
  encode_chroma → uvmode (B, mh, mw) uint8; uv_levels (B, mh, mw, 8, 16)
                  int16 zigzag, U blocks 0-3 then V blocks 4-7

The halo forms (``halo=``; ``encode_luma`` and ``encode_chroma`` with
the levels) encode one width tile of a plane split over devices
(parallel/shard.py ``sharded_encode_plane_step``): the MB column 0 reads
its left column and corner from ``halo``, (B, H) uint8 (a pair of them
for U and V), the left neighbour's last source column, instead of the
129 edge fill.

``encode_luma_modes`` and ``encode_chroma_modes`` are the modes-only
forms (the same kernels built without the transform and the levels):
ymode / uvmode alone, for the hybrid engine's cold round
(``encode_modes``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import dct
from ..vp8_recon import mb_context, predict4_blocks
from .cuda_build import CudaLibrary, check_tensor, stream_handle

I16, I32, U8 = torch.int16, torch.int32, torch.uint8


def _configure(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.encode_luma_launch.restype = ctypes.c_int
    lib.encode_luma_launch.argtypes = [p, ll] + [i] * 11 + [p] * 5
    lib.encode_chroma_launch.restype = ctypes.c_int
    lib.encode_chroma_launch.argtypes = [p, ll, p, ll] + [i] * 7 + [p] * 5
    lib.encode_plane_occupancy.restype = i
    lib.encode_plane_occupancy.argtypes = [i] + [
        ctypes.POINTER(ctypes.c_int)] * 2


LIBRARY = CudaLibrary("encode_plane.cu", _configure)


def _first_min(sse):
    """(4, ...) SSEs → index of the first minimum: DC, TM, VE, HE in
    order, a later mode wins only when strictly smaller."""
    best, mode = sse[0], torch.zeros_like(sse[0])
    for m in range(1, 4):
        better = sse[m] < best
        mode = torch.where(better, m, mode)
        best = torch.where(better, sse[m], best)
    return mode


def _search(planes, size: int, residual: bool = True, halos=None):
    """Joint SSE mode search of MB-aligned planes sharing one MB grid →
    (mode (B, N), [residual blocks (B, N, nb*nb, 4, 4) per plane], the
    list empty when not ``residual``).  ``halos``: each plane's (B, H)
    left halo column (``mb_context``'s ``left_halo``)."""
    B, H, W = planes[0].shape
    mh, mw = H // size, W // size
    N, nb = mh * mw, size // 4
    sse, pairs = 0, []
    for i, p in enumerate(planes):
        p = p.to(I32)
        top, _, left, tl, ht, hl = mb_context(
            p, mh, mw, size, None if halos is None else halos[i])
        pred4 = predict4_blocks(top, left, tl, ht, hl, size)  # (4,B,N,s,s)
        src = p.reshape(B, mh, size, mw, size).permute(0, 1, 3, 2, 4)
        src = src.reshape(B, N, size, size)
        d = src[None] - pred4
        sse = sse + (d * d).sum(dim=(-1, -2), dtype=I32)
        pairs.append((src, pred4))
    mode = _first_min(sse)
    if not residual:
        return mode, []
    b = torch.arange(B, device=mode.device)[:, None]
    n = torch.arange(N, device=mode.device)[None, :]
    res = []
    for src, pred4 in pairs:
        r = src - pred4[mode.long(), b, n]
        res.append(r.reshape(B, N, nb, 4, nb, 4).permute(0, 1, 2, 4, 3, 5)
                   .reshape(B, N, nb * nb, 4, 4))
    return mode, res


def encode_luma_plain(y, quants, y2_quants, halo=None):
    """Plain torch version of the luma kernel and its halo form (any
    device)."""
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    mode, (res,) = _search([y], 16, halos=None if halo is None else [halo])
    cf = dct.fdct4x4(res)                                # (B, N, 16, 4, 4)
    lv = dct.quantize(cf, *quants, first_ac=True)
    y2 = dct.fwht4x4(cf[..., 0, 0].reshape(B, mh * mw, 4, 4))
    return (mode.reshape(B, mh, mw).to(U8),
            lv.reshape(B, mh, mw, 16, 16).to(I16),
            dct.quantize(y2, *y2_quants).reshape(B, mh, mw, 16).to(I16))


def encode_chroma_plain(u, v, quants, halo=None):
    """Plain torch version of the chroma kernel and its halo form (any
    device); ``halo`` the (u, v) pair of left columns."""
    B, H, W = u.shape
    mh, mw = H // 8, W // 8
    mode, res = _search([u, v], 8, halos=halo)
    lv = dct.quantize(dct.fdct4x4(torch.cat(res, dim=2)), *quants)
    return (mode.reshape(B, mh, mw).to(U8),
            lv.reshape(B, mh, mw, 8, 16).to(I16))


def encode_luma_modes_plain(y):
    """Plain torch version of the luma kernel's modes-only form (any
    device): ymode (B, mh, mw) uint8.  ``calls`` counts its calls."""
    encode_luma_modes_plain.calls += 1
    B, H, W = y.shape
    return _search([y], 16, residual=False)[0].reshape(
        B, H // 16, W // 16).to(U8)


def encode_chroma_modes_plain(u, v):
    """Plain torch version of the chroma kernel's modes-only form (any
    device): uvmode (B, mh, mw) uint8.  ``calls`` counts its calls."""
    encode_chroma_modes_plain.calls += 1
    B, H, W = u.shape
    return _search([u, v], 8, residual=False)[0].reshape(
        B, H // 8, W // 8).to(U8)


def _check_plane(name: str, t, size: int, device):
    """Raise unless ``t`` is a (B, H, W) uint8 plane on ``device`` with
    H, W multiples of ``size`` and contiguous rows; → (B, mh, mw)."""
    if t.dtype != U8:
        raise TypeError(f"{name}: expected torch.uint8, got {t.dtype}")
    if t.dim() != 3 or t.shape[1] % size or t.shape[2] % size \
            or 0 in t.shape:
        raise ValueError(f"{name}: expected (B, H, W) with H and W "
                         f"multiples of {size}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
        raise ValueError(f"{name}: rows must be contiguous")
    return t.shape[0], t.shape[1] // size, t.shape[2] // size


def _check_halo(name: str, t, B: int, H: int, device):
    """Raise unless ``t`` is a contiguous (B, H) uint8 halo column."""
    check_tensor(name, t, U8, (B, H), device)


def _quant_args(quants):
    return tuple(int(q) for q in quants)


KERNELS = ("encode_luma", "encode_chroma", "encode_luma_modes",
           "encode_chroma_modes")


def occupancy(name: str):
    """(SMs, 128-thread blocks an SM holds at once) of kernel ``name`` (one
    of ``KERNELS``) on the current card.  Needs the card."""
    lib = LIBRARY.load()
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.encode_plane_occupancy(KERNELS.index(name), ctypes.byref(sms),
                                     ctypes.byref(per_sm))
    if err != 0:
        raise RuntimeError(f"{name} occupancy: CUDA error {err}")
    return sms.value, per_sm.value


_NO_QUANTS = (0, 0, 0, 0)


def _device(name: str, t):
    """t's device; raises unless it is the CPU or CUDA."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _launch_luma(y, quants, y2_quants, code: bool, halo=None):
    """One luma kernel launch: (ymode, y_levels, y2_levels), the levels
    None in the modes-only form; ``halo`` (with ``code``) the halo form."""
    dev = y.device
    B, mh, mw = _check_plane("y", y, 16, dev)
    lib = LIBRARY.load()
    ymode = torch.empty((B, mh, mw), dtype=U8, device=dev)
    levels = y2_levels = None
    if code:
        levels = torch.empty((B, mh, mw, 16, 16), dtype=I16, device=dev)
        y2_levels = torch.empty((B, mh, mw, 16), dtype=I16, device=dev)
    if halo is not None:
        _check_halo("halo", halo, B, 16 * mh, dev)
    err = lib.encode_luma_launch(
        y.data_ptr(), y.stride(0), B, mh, mw, *_quant_args(quants),
        *_quant_args(y2_quants), levels.data_ptr() if code else None,
        y2_levels.data_ptr() if code else None, ymode.data_ptr(),
        None if halo is None else halo.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"encode_luma kernel launch failed: CUDA error {err}")
    return ymode, levels, y2_levels


def _launch_chroma(u, v, quants, code: bool, halo=None):
    """One chroma kernel launch: (uvmode, uv_levels), the levels None in
    the modes-only form; ``halo`` (with ``code``) the (u, v) halo pair of
    the halo form."""
    dev = u.device
    B, mh, mw = _check_plane("u", u, 8, dev)
    if _check_plane("v", v, 8, dev) != (B, mh, mw):
        raise ValueError("encode_chroma: u and v planes differ in shape")
    lib = LIBRARY.load()
    uvmode = torch.empty((B, mh, mw), dtype=U8, device=dev)
    levels = (torch.empty((B, mh, mw, 8, 16), dtype=I16, device=dev)
              if code else None)
    hp = (None, None)
    if halo is not None:
        hu, hv = halo
        _check_halo("u_halo", hu, B, 8 * mh, dev)
        _check_halo("v_halo", hv, B, 8 * mh, dev)
        hp = (hu.data_ptr(), hv.data_ptr())
    err = lib.encode_chroma_launch(
        u.data_ptr(), u.stride(0), v.data_ptr(), v.stride(0), B, mh, mw,
        *_quant_args(quants), levels.data_ptr() if code else None,
        uvmode.data_ptr(), *hp, stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"encode_chroma kernel launch failed: CUDA error {err}")
    return uvmode, levels


def encode_luma(y, quants, y2_quants, halo=None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor; ``halo``
    (B, H) uint8 the halo form.

    ``encode_luma.launches`` counts kernel launches (one per call on
    CUDA), ``encode_luma.halo_launches`` those of the halo form among
    them.
    """
    if _device("encode_luma", y).type == "cpu":
        return encode_luma_plain(y, quants, y2_quants, halo)
    out = _launch_luma(y, quants, y2_quants, code=True, halo=halo)
    encode_luma.launches += 1
    encode_luma.halo_launches += halo is not None
    return out


def encode_chroma(u, v, quants, halo=None):
    """Kernel on a CUDA tensor, plain version on a CPU tensor; ``halo``
    the (u, v) pair of (B, H) uint8 columns: the halo form.

    ``encode_chroma.launches`` counts kernel launches (one per call on
    CUDA), ``encode_chroma.halo_launches`` those of the halo form among
    them.
    """
    if _device("encode_chroma", u).type == "cpu":
        return encode_chroma_plain(u, v, quants, halo)
    out = _launch_chroma(u, v, quants, code=True, halo=halo)
    encode_chroma.launches += 1
    encode_chroma.halo_launches += halo is not None
    return out


def encode_luma_modes(y):
    """The luma kernel's modes-only form on a CUDA tensor, its plain
    version on a CPU tensor → ymode (B, mh, mw) uint8.

    ``encode_luma_modes.launches`` counts kernel launches.
    """
    if _device("encode_luma_modes", y).type == "cpu":
        return encode_luma_modes_plain(y)
    ymode = _launch_luma(y, _NO_QUANTS, _NO_QUANTS, code=False)[0]
    encode_luma_modes.launches += 1
    return ymode


def encode_chroma_modes(u, v):
    """The chroma kernel's modes-only form on CUDA tensors, its plain
    version on CPU tensors → uvmode (B, mh, mw) uint8.

    ``encode_chroma_modes.launches`` counts kernel launches.
    """
    if _device("encode_chroma_modes", u).type == "cpu":
        return encode_chroma_modes_plain(u, v)
    uvmode = _launch_chroma(u, v, _NO_QUANTS, code=False)[0]
    encode_chroma_modes.launches += 1
    return uvmode


def encode_modes(y, u, v):
    """The open-loop i16 and uv modes of uint8 MB-padded planes: one
    launch of each modes-only kernel on CUDA, the plain versions on the
    CPU → (ymode, uvmode) (B, mh, mw) uint8."""
    return encode_luma_modes(y), encode_chroma_modes(u, v)


encode_luma.launches = 0
encode_chroma.launches = 0
encode_luma.halo_launches = 0
encode_chroma.halo_launches = 0
encode_luma_modes.launches = 0
encode_chroma_modes.launches = 0
encode_luma_modes_plain.calls = 0
encode_chroma_modes_plain.calls = 0

__all__ = ["KERNELS", "LIBRARY", "encode_chroma", "encode_chroma_modes",
           "encode_chroma_modes_plain", "encode_chroma_plain", "encode_luma",
           "encode_luma_modes", "encode_luma_modes_plain",
           "encode_luma_plain", "encode_modes", "occupancy"]
