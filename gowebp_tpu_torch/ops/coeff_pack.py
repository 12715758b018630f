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
native layer (entropy/native/vp8_dec.cpp ``wtpu_vp8_pack_stats`` and
``wtpu_vp8_pack_emit``, one call per image, GIL released) on the symbol
thread that decoded the group; ``pack_coeffs_plain`` is its numpy
version, which only the tests run.  The device's unpack is the
``unpack_coeffs`` kernel (ops/kernels/coeff_unpack.py).
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


def pack_images(coeffs, seg, is_i4, qmat) -> tuple[dict, int]:
    """Pack B images given one by one: ``coeffs[b]`` (N, 24, 16) int16
    raster (the symbol engine's output, no copy made), ``seg[b]`` and
    ``is_i4[b]`` (N,) per MB, ``qmat[b]`` (4, 6) int32 rows (y1_dc,
    y1_ac, y2_dc, y2_ac, uv_dc, uv_ac) → (dict of numpy arrays, K).
    Each image runs the native stats, then the native emit into its
    slices of the batch's arrays."""
    lib = get_lib()
    B, N = len(coeffs), coeffs[0].shape[0]
    ins = []
    counts = np.zeros((B, 3), np.int32)
    for b in range(B):
        one = (np.ascontiguousarray(coeffs[b], np.int16),
               np.ascontiguousarray(seg[b], np.uint8),
               np.ascontiguousarray(is_i4[b], np.uint8),
               np.ascontiguousarray(qmat[b], np.int32))
        if one[0].shape != (N, 24, 16):
            raise ValueError(f"pack: image {b} coeffs {one[0].shape} is not "
                             f"({N}, 24, 16)")
        lib.wtpu_vp8_pack_stats(
            _ptr(one[0], ctypes.c_int16), _ptr(one[1], ctypes.c_uint8),
            _ptr(one[2], ctypes.c_uint8), _ptr(one[3], ctypes.c_int32), 1, N,
            _ptr(counts[b], ctypes.c_int32))
        ins.append(one)
    n_base, n_t4, n_t8 = (int(x) for x in counts.sum(0))
    K = _choose_k(B * N * 24, n_base, n_t4, n_t8)
    ntail = (np.zeros(B, np.int64) if K == 16
             else counts[:, 2 if K == 8 else 1].astype(np.int64))
    nexc = counts[:, 0].astype(np.int64)
    toff = np.concatenate([[0], np.cumsum(ntail)])
    eoff = np.concatenate([[0], np.cumsum(nexc)])
    tw = max(1, 16 - K)
    out = {
        "lv8": np.empty((B, N, 24, K), np.int8),
        "dc16": np.empty((B, N, 16), np.int16),
        "tail_idx": np.empty(int(toff[-1]), np.int32),
        "tail_val": np.zeros((int(toff[-1]), tw), np.int8),
        "exc_idx": np.empty(int(eoff[-1]), np.int32),
        "exc_val": np.empty((int(eoff[-1]), 16), np.int16),
        "seg": np.stack([one[1] for one in ins]),
        "is_i4": np.stack([one[2] for one in ins]),
        "qmat": np.stack([one[3] for one in ins]),
    }
    done = np.zeros(2, np.int64)
    for b, (c, s, i4, q) in enumerate(ins):
        ti = out["tail_idx"][toff[b]:toff[b + 1]]
        tv = out["tail_val"][toff[b]:toff[b + 1]]
        ei = out["exc_idx"][eoff[b]:eoff[b + 1]]
        ev = out["exc_val"][eoff[b]:eoff[b + 1]]
        rc = lib.wtpu_vp8_pack_emit(
            _ptr(c, ctypes.c_int16), _ptr(s, ctypes.c_uint8),
            _ptr(i4, ctypes.c_uint8), _ptr(q, ctypes.c_int32), 1, N, K,
            _ptr(out["lv8"][b], ctypes.c_int8),
            _ptr(out["dc16"][b], ctypes.c_int16),
            _ptr(ti, ctypes.c_int32), _ptr(tv, ctypes.c_int8), len(ti),
            _ptr(ei, ctypes.c_int32), _ptr(ev, ctypes.c_int16), len(ei),
            _ptr(done, ctypes.c_int64))
        if rc != 0 or done[0] != len(ti) or done[1] != len(ei):
            raise RuntimeError(f"pack: image {b} emitted {done.tolist()} "
                               f"rows, its stats counted "
                               f"{[len(ti), len(ei)]}")
        ti += b * N * 24
        ei += b * N * 24
    return out, K


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
