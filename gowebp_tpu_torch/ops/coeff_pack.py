"""The batch decode's sparse coefficient upload: the host pack.

The dense upload of a lossy group is its (B, N, 24, 16) int16
dequantized coefficients, 768 B a macroblock.  Most of them are zero, and
every non-zero one is a quantization level times its quantizer, so
``pack_coeffs`` re-compresses the symbol engine's output into

- ``lv8``: int8 levels in zigzag order, the first K of each block
  (K in {4, 8, 16}, one K a group, chosen by ``_choose_k``); a level is
  recovered by exact division by its segment's quantizer;
- ``dc16``: the i16 MBs' luma DC lanes (inverse-WHT outputs, not level
  multiples) as a (B, N, 16) int16 side plane;
- ``tail_idx`` / ``tail_val``: for each block whose non-zeros reach past
  position K, its flat block index and its remaining 16-K int8 levels;
- ``exc_idx`` / ``exc_val``: for each block with a level above 127 in
  magnitude or a coefficient that does not divide by its quantizer, its
  flat block index and its raw int16 zigzag row;
- ``seg``, ``is_i4`` and ``qmat``: the per-MB segment and i4 flag, and
  each image's (4, 6) quantizer rows, with which the device multiplies
  the levels back.

The tables hold exactly their rows, in block order.  The pack runs in the
native layer (entropy/native/vp8_dec.cpp ``wtpu_vp8_pack_scan`` and
``wtpu_vp8_pack_emit``, one call each a group, GIL released) on the
symbol thread that decoded the group: the scan reads each dense block
once, with no integer division, into the wire layout of K = 4, and the
emit writes the exception rows and, at K = 8 or 16, the wider layout.
``pack_coeffs_plain`` is its numpy version, which only the tests run.
The device's unpack is the ``unpack_coeffs`` kernel
(ops/kernels/coeff_unpack.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..entropy.native_loader import get_lib

# zigzag position n -> raster index (RFC 6386)
_ZZ = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
               np.int32)

# Wire-byte equivalents charged per table row for the unpack's work on
# it.  On an H100 80GB HBM3 (700 W) a tail row costs the unpack kernel
# ~0.01 ns of device time (the kernel with and without the 32 hybrid
# files' 926,381 tail rows at K=4), a wire byte the group's upload (the
# host buffer's fill and the pageable h2d copy) 0.5-0.65 ns: a row is
# worth under a fiftieth of a byte, so K goes by wire bytes alone
# (chip_smoke.py phase 3i, PERF.md).
_ROW_COST = 0


def _choose_k(nblocks: int, n_base: int, n_t4: int, n_t8: int) -> int:
    """K by total cost: wire bytes (a tail row 4 + 16 - K, an exception
    row 36) plus ``_ROW_COST`` a row."""
    best_k = 16
    best = nblocks * 16 + n_base * (36 + _ROW_COST)
    for K, ntail in ((8, n_t8), (4, n_t4)):
        cost = (nblocks * K + ntail * (4 + 16 - K + _ROW_COST)
                + n_base * (36 + _ROW_COST))
        if cost < best:
            best_k, best = K, cost
    return best_k


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def pack_images(coeffs, seg, is_i4, qmat, counts=None) -> tuple[dict, int]:
    """Pack B images given one by one: ``coeffs[b]`` (N, 24, 16) int16
    raster (the symbol engine's output, no copy made), ``seg[b]`` and
    ``is_i4[b]`` (N,) per MB, ``qmat[b]`` (4, 6) int32 rows (y1_dc,
    y1_ac, y2_dc, y2_ac, uv_dc, uv_ac) → (dict of numpy arrays, K).

    Two native calls for the whole group: the scan reads every dense
    block once and writes the wire layout of K = 4, then, with K chosen
    from its counts, the emit writes the exception rows and, at K = 8 or
    16, lv8 and the tail table from that layout.  ``counts``, when given,
    is a dict to which the group's ``blocks``, ``zero_blocks``,
    ``tail_rows`` and ``exc_rows`` are added and whose ``K`` becomes the
    largest K it has seen."""
    lib = get_lib()
    B, N = len(coeffs), coeffs[0].shape[0]
    cs = [np.ascontiguousarray(c, np.int16) for c in coeffs]
    for b, c in enumerate(cs):
        if c.shape != (N, 24, 16):
            raise ValueError(f"pack: image {b} coeffs {c.shape} is not "
                             f"({N}, 24, 16)")
    ptrs = (ctypes.c_void_p * B)(*(c.ctypes.data for c in cs))
    seg = np.stack(seg).astype(np.uint8, copy=False)
    is_i4 = np.stack(is_i4).astype(np.uint8, copy=False)
    qmat = np.stack(qmat).astype(np.int32, copy=False)
    if seg.shape != (B, N) or is_i4.shape != (B, N) or \
            qmat.shape != (B, 4, 6):
        raise ValueError(f"pack: seg {seg.shape}, is_i4 {is_i4.shape} and "
                         f"qmat {qmat.shape} do not fit {B} images of {N} "
                         f"MBs")
    nblocks = B * N * 24
    # the K = 4 layout, each table with room for every block (only the
    # pages of its rows are ever touched)
    head = np.empty((B, N, 24, 4), np.int8)
    dc16 = np.empty((B, N, 16), np.int16)
    t4_idx = np.empty(nblocks, np.int32)
    t4_val = np.empty(nblocks * 12, np.int8)
    exc_idx = np.empty(nblocks, np.int32)
    scan = np.zeros(4, np.int64)
    lib.wtpu_vp8_pack_scan(
        ptrs, _ptr(seg, ctypes.c_uint8), _ptr(is_i4, ctypes.c_uint8),
        _ptr(qmat, ctypes.c_int32), B, N, _ptr(head, ctypes.c_int8),
        _ptr(dc16, ctypes.c_int16), _ptr(t4_idx, ctypes.c_int32),
        _ptr(t4_val, ctypes.c_int8), _ptr(exc_idx, ctypes.c_int32),
        _ptr(scan, ctypes.c_int64))
    n_zero, n_exc, n_t4, n_t8 = (int(x) for x in scan)
    K = _choose_k(nblocks, n_exc, n_t4, n_t8)
    ntail = 0 if K == 16 else n_t8 if K == 8 else n_t4
    tw = max(1, 16 - K)
    if K == 4:
        lv8, tail_idx = head, t4_idx[:n_t4]
        tail_val = t4_val[:n_t4 * 12].reshape(n_t4, 12)
    else:
        lv8 = np.empty((B, N, 24, K), np.int8)
        tail_idx = np.empty(ntail, np.int32)
        tail_val = np.empty((ntail, tw), np.int8)
    exc_val = np.empty((n_exc, 16), np.int16)
    got = lib.wtpu_vp8_pack_emit(
        ptrs, B, N, K, _ptr(head, ctypes.c_int8),
        _ptr(t4_idx, ctypes.c_int32), _ptr(t4_val, ctypes.c_int8), n_t4,
        _ptr(exc_idx, ctypes.c_int32), n_exc, _ptr(exc_val, ctypes.c_int16),
        _ptr(lv8, ctypes.c_int8), _ptr(tail_idx, ctypes.c_int32),
        _ptr(tail_val, ctypes.c_int8), ntail)
    if got != ntail:
        raise RuntimeError(f"pack: emitted {got} tail rows at K={K}, the "
                           f"scan counted {ntail}")
    if counts is not None:
        for key, n in (("blocks", nblocks), ("zero_blocks", n_zero),
                       ("tail_rows", ntail), ("exc_rows", n_exc)):
            counts[key] = counts.get(key, 0) + n
        counts["K"] = max(counts.get("K", 0), K)
    return {"lv8": lv8, "dc16": dc16, "tail_idx": tail_idx,
            "tail_val": tail_val, "exc_idx": exc_idx[:n_exc],
            "exc_val": exc_val, "seg": seg, "is_i4": is_i4,
            "qmat": qmat}, K


def pack_coeffs(coeffs: np.ndarray, seg: np.ndarray, is_i4: np.ndarray,
                qmat: np.ndarray) -> tuple[dict, int]:
    """Pack dequantized coefficients into the wire layout (native).

    coeffs: (B, N, 24, 16) int16 raster; seg/is_i4: (B, N) per-MB segment
    id / i4 flag; qmat: (B, 4, 6) int32 per-image per-segment (y1_dc,
    y1_ac, y2_dc, y2_ac, uv_dc, uv_ac).  Returns (dict of numpy arrays,
    K).
    """
    return pack_images(list(np.asarray(coeffs)), list(np.asarray(seg)),
                       list(np.asarray(is_i4)), list(np.asarray(qmat)))


def pack_coeffs_plain(coeffs: np.ndarray, seg: np.ndarray,
                      is_i4: np.ndarray, qmat: np.ndarray) -> tuple[dict, int]:
    """numpy version of :func:`pack_coeffs` (the same arrays)."""
    B, N = coeffs.shape[:2]
    c = np.ascontiguousarray(coeffs, np.int16)
    seg = np.asarray(seg).astype(np.int64)
    qs = np.asarray(qmat).astype(np.int32)              # (B, 4, 6)
    is_luma = np.arange(24) < 16                        # (24,)

    def per_image(b):
        zz = c[b][..., _ZZ].astype(np.int32)            # (N, 24, 16)
        sg = seg[b]
        q_ac = np.where(is_luma[None, :], qs[b, sg, 1][:, None],
                        qs[b, sg, 5][:, None]).astype(np.int32)
        q_dc = np.where(is_luma[None, :], qs[b, sg, 0][:, None],
                        qs[b, sg, 4][:, None]).astype(np.int32)
        q = np.empty((N, 24, 16), np.int32)
        q[..., 0] = q_dc
        q[..., 1:] = q_ac[..., None]
        # i16 luma DC lanes are inverse-WHT outputs: excluded from the
        # level math, carried in the dense dc16 side plane instead.
        i16mask = (np.asarray(is_i4[b]).astype(np.int64) == 0)[:, None] \
            & is_luma[None]
        dc16_b = np.where(i16mask, c[b][..., 0], 0)[:, :16].astype(np.int16)
        zz_lv = zz.copy()
        zz_lv[..., 0] = np.where(i16mask, 0, zz[..., 0])
        # |level| < 2^12 and q < 2^9, so float32 division + rint is exact;
        # a lane failing the multiply-back check makes its block an
        # exception.
        lv = np.rint(zz_lv.astype(np.float32)
                     / q.astype(np.float32)).astype(np.int32)
        base = ((lv * q != zz_lv).any(axis=-1)
                | (np.abs(lv) > 127).any(axis=-1))      # (N, 24)
        nzpos = zz != 0                      # raw values decide the eob
        tail8 = nzpos[..., 8:].any(axis=-1)
        tail4 = tail8 | nzpos[..., 4:8].any(axis=-1)
        return zz, lv, base, tail4, tail8, dc16_b

    per = [per_image(b) for b in range(B)]
    nblocks = B * N * 24
    n_base = sum(int(p[2].sum()) for p in per)
    n_t4 = sum(int((p[3] & ~p[2]).sum()) for p in per)
    n_t8 = sum(int((p[4] & ~p[2]).sum()) for p in per)
    K = _choose_k(nblocks, n_base, n_t4, n_t8)

    lv8 = np.empty((B, N, 24, K), np.int8)
    tidx, tval, eidx, evals = [], [], [], []
    for b, (zz, lv, base, tail4, tail8, _) in enumerate(per):
        tail = (np.zeros_like(base) if K == 16
                else ((tail4 if K == 4 else tail8) & ~base))
        lv8[b] = np.where(base[..., None], 0, lv)[..., :K].astype(np.int8)
        ti = np.flatnonzero(tail.reshape(-1)).astype(np.int32)
        tidx.append(ti + b * N * 24)
        tval.append(lv.reshape(-1, 16)[ti, K:].astype(np.int8))
        fi = np.flatnonzero(base.reshape(-1)).astype(np.int32)
        eidx.append(fi + b * N * 24)
        evals.append(zz.reshape(-1, 16)[fi].astype(np.int16))
    tw = max(1, 16 - K)
    tail_val = np.concatenate(tval) if K < 16 else np.zeros((0, tw), np.int8)
    return {
        "lv8": lv8,
        "dc16": np.stack([p[5] for p in per]),
        "tail_idx": np.concatenate(tidx).astype(np.int32),
        "tail_val": tail_val.reshape(-1, tw),
        "exc_idx": np.concatenate(eidx).astype(np.int32),
        "exc_val": np.concatenate(evals).reshape(-1, 16),
        "seg": seg.astype(np.uint8),
        "is_i4": np.asarray(is_i4).astype(np.uint8),
        "qmat": qs,
    }, K


def packed_nbytes(packed) -> int:
    """Total wire bytes of a packed dict."""
    return sum(int(a.nbytes) for a in packed.values())


__all__ = ["pack_coeffs", "pack_coeffs_plain", "pack_images", "packed_nbytes"]
