"""Batched VP8 transforms in PyTorch — exact int32 arithmetic.

All functions operate on arbitrarily-batched blocks (..., 4, 4) or
(..., 16) of int32.  Every ``>>`` is an arithmetic shift on a signed
int32 tensor (never a division), exactly as the bitstream defines it.
The zigzag permutations are integer indexing.
"""

from __future__ import annotations

import functools

import torch

from ..models.vp8.tables import ZIGZAG

I32 = torch.int32

BIAS = {  # b8 << 9 quantizer rounding bias per coefficient class
    "y1_dc": 96 << 9, "y1_ac": 110 << 9,
    "y2_dc": 96 << 9, "y2_ac": 96 << 9,
    "uv_dc": 110 << 9, "uv_ac": 110 << 9,
}

_ZIGZAG = tuple(int(i) for i in ZIGZAG)                # out[i] = in[ZZ[i]]
_INV_ZIGZAG = tuple(_ZIGZAG.index(i) for i in range(16))  # out[i] = in[IZZ[i]]


@functools.lru_cache(maxsize=None)
def index_tensor(order: tuple, device: torch.device) -> torch.Tensor:
    """A constant index list as a tensor on ``device``, made once: an
    index list given as such is copied to the device at every use, and
    that copy waits for the stream."""
    return torch.tensor(order, dtype=torch.int64, device=device)


def zigzag_fwd(flat: torch.Tensor) -> torch.Tensor:
    """(..., 16) raster → zigzag order."""
    return flat[..., index_tensor(_ZIGZAG, flat.device)]


def zigzag_inv(zz: torch.Tensor) -> torch.Tensor:
    """(..., 16) zigzag → raster order."""
    return zz[..., index_tensor(_INV_ZIGZAG, zz.device)]


def _mul1(a):
    return a + ((a * 20091) >> 16)


def _mul2(a):
    return (a * 35468) >> 16


def idct4x4(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int32 coeffs → (..., 4, 4) int32 residual (pre-clip)."""
    c = coeffs.to(I32)
    a = c[..., 0, :] + c[..., 2, :]
    b = c[..., 0, :] - c[..., 2, :]
    cc = _mul2(c[..., 1, :]) - _mul1(c[..., 3, :])
    d = _mul1(c[..., 1, :]) + _mul2(c[..., 3, :])
    tmp = torch.stack([a + d, b + cc, b - cc, a - d], dim=-2)
    t0 = tmp[..., :, 0] + 4
    t1 = tmp[..., :, 1]
    t2 = tmp[..., :, 2]
    t3 = tmp[..., :, 3]
    a = t0 + t2
    b = t0 - t2
    cc = _mul2(t1) - _mul1(t3)
    d = _mul1(t1) + _mul2(t3)
    out = torch.stack([a + d, b + cc, b - cc, a - d], dim=-1)
    return out >> 3


def idct_add_clip(coeffs: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """pred (..., 4, 4) uint8-valued + iDCT(coeffs), clipped to [0,255]."""
    return torch.clamp(pred.to(I32) + idct4x4(coeffs), 0, 255)


def fdct4x4(block: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int32 residual → (..., 4, 4) int32 coefficients."""
    d = block.to(I32)
    d0, d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2], d[..., :, 3]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = torch.stack([t0, t1, t2, t3], dim=-1)         # (..., row, col)
    p0, p1, p2, p3 = tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :], tmp[..., 3, :]
    a0 = p0 + p3
    a1 = p1 + p2
    a2 = p1 - p2
    a3 = p0 - p3
    o0 = (a0 + a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).to(I32)
    o2 = (a0 - a1 + 7) >> 4
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return torch.stack([o0, o1, o2, o3], dim=-2)


def fwht4x4(dcs: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int32 per-block DCs → (..., 4, 4) WHT coefficients."""
    c = dcs.to(I32)
    a0 = c[..., :, 0] + c[..., :, 3]
    a1 = c[..., :, 1] + c[..., :, 2]
    a2 = c[..., :, 1] - c[..., :, 2]
    a3 = c[..., :, 0] - c[..., :, 3]
    tmp = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-1)
    a0 = tmp[..., 0, :] + tmp[..., 3, :]
    a1 = tmp[..., 1, :] + tmp[..., 2, :]
    a2 = tmp[..., 1, :] - tmp[..., 2, :]
    a3 = tmp[..., 0, :] - tmp[..., 3, :]
    return torch.stack(
        [(a0 + a1) >> 1, (a3 + a2) >> 1, (a0 - a1) >> 1, (a3 - a2) >> 1],
        dim=-2,
    )


def iwht4x4(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) int32 Y2 coeffs → (..., 4, 4) per-block DC values."""
    c = coeffs.to(I32)
    a0 = c[..., 0, :] + c[..., 3, :]
    a1 = c[..., 1, :] + c[..., 2, :]
    a2 = c[..., 1, :] - c[..., 2, :]
    a3 = c[..., 0, :] - c[..., 3, :]
    tmp = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-2)
    dc = tmp[..., :, 0] + 3
    a0 = dc + tmp[..., :, 3]
    a1 = tmp[..., :, 1] + tmp[..., :, 2]
    a2 = tmp[..., :, 1] - tmp[..., :, 2]
    a3 = dc - tmp[..., :, 3]
    return torch.stack(
        [(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3],
        dim=-1,
    )


def quantize(coeffs: torch.Tensor, dc_iq, dc_bias: int, ac_iq, ac_bias: int,
             first_ac: bool = False) -> torch.Tensor:
    """(..., 4, 4) raster coeffs → (..., 16) zigzag levels (QUANTDIV).

    dc_iq/ac_iq: ints or int32 tensors broadcastable to coeffs.shape[:-2]
    (per-block quantizers); biases are static ints.
    """
    zz = zigzag_fwd(coeffs.reshape(coeffs.shape[:-2] + (16,)).to(I32))
    pos0 = torch.arange(16, device=zz.device) == 0
    iq = torch.where(pos0, _lanes(dc_iq, zz), _lanes(ac_iq, zz))
    bias = torch.where(pos0, dc_bias, ac_bias).to(I32)
    level = torch.clamp_max((zz.abs() * iq + bias) >> 17, 2047)
    if first_ac:
        level = torch.where(pos0, 0, level)
    return torch.where(zz < 0, -level, level)


def dequantize(levels: torch.Tensor, dc_q, ac_q) -> torch.Tensor:
    """(..., 16) zigzag levels → (..., 4, 4) raster coefficients."""
    lv = levels.to(I32)
    pos0 = torch.arange(16, device=lv.device) == 0
    deq = lv * torch.where(pos0, _lanes(dc_q, lv), _lanes(ac_q, lv))
    return zigzag_inv(deq).reshape(levels.shape[:-1] + (4, 4))


def _lanes(q, like: torch.Tensor) -> torch.Tensor:
    """int or (...) int32 tensor → broadcastable against (..., 16)."""
    if isinstance(q, torch.Tensor):
        return q.to(I32)[..., None]
    return torch.tensor(int(q), dtype=I32, device=like.device)


__all__ = [
    "BIAS",
    "index_tensor",
    "dequantize",
    "fdct4x4",
    "fwht4x4",
    "idct4x4",
    "idct_add_clip",
    "iwht4x4",
    "quantize",
    "zigzag_fwd",
    "zigzag_inv",
]
