"""Exact VP8 token-grammar rate model in PyTorch (1/256-bit units).

The cost of coding one quantized block's zigzag levels under fixed
probability tables — EOB/continue bits, zero-run bits, value tokens
(sign as a flat bit) — bit-identical to the host encoder's
``block_rate256``.

The sequential grammar walk is re-expressed positionally: position n is
a "decision point" iff n == first or level[n-1] != 0; its context is
ctx0 at `first`, else 0 after a zero-run step, else 1/2 by the
magnitude of the preceding value.  All 16 positions are charged in
parallel and masked by n <= last_nonzero, with the end-of-block bit
read at last_nonzero + 1.  Table reads are integer indexing.
"""

from __future__ import annotations

import torch

from ..models.vp8.tables import BANDS
from .dct import index_tensor

I32 = torch.int32
_BANDS16 = tuple(int(b) for b in BANDS[:16])           # band of position n


def position_tables(tables, type: int):
    """(p0, p1, val) [4][8][3][...] → per-position (16, 3, ...) int32 rows."""
    p0_t, p1_t, val_t = tables
    bands = index_tensor(_BANDS16, p0_t.device)
    return tuple(t[type][bands].to(I32).contiguous()
                 for t in (p0_t, p1_t, val_t))


def block_rate256(lv, tables, *, type: int, first: int, ctx0: int):
    """Token rate of zigzag levels (..., 16) in 1/256 bits → (...) int32.

    tables: (p0, p1, val) int32 tensors of shape (4,8,3,2), (4,8,3,2),
    (4,8,3,68).  type/first/ctx0 are static ints.
    """
    p0_n, p1_n, val_n = position_tables(tables, type)
    return rate_by_position(lv, p0_n, p1_n, val_n, first=first, ctx0=ctx0)


def rate_by_position(lv, p0_n, p1_n, val_n, *, first: int, ctx0: int):
    """block_rate256 on per-position tables p0/p1 (16,3,2), val (16,3,68)."""
    lv = lv.to(I32)
    dev = lv.device
    nz = lv != 0
    v = torch.clamp_max(lv.abs(), 67)

    idx = torch.arange(16, dtype=I32, device=dev)
    pos_ok = idx >= first
    nz_eff = nz & pos_ok
    has = nz_eff.any(dim=-1)
    last = torch.where(nz_eff, idx, -1).amax(dim=-1)      # (-1 if empty)

    prev_nz = torch.cat([torch.zeros_like(nz[..., :1]), nz_eff[..., :-1]], -1)
    prev_v = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)
    is_first = idx == first
    decision = is_first | prev_nz
    ctx = torch.where(
        is_first, ctx0,
        torch.where(prev_nz, torch.where(prev_v == 1, 1, 2), 0),
    ).long()                                              # (..., 16)

    # flat table index of (position n, ctx) per lane
    row = idx.long() * 3 + ctx
    p0f = p0_n.reshape(48, 2)
    p1f = p1_n.reshape(48, 2)
    p0_1 = p0f[row, 1]
    p0_0 = p0f[row, 0]
    p1_0 = p1f[row, 0]
    p1_1 = p1f[row, 1]
    vcost = val_n.reshape(-1)[row * 68 + v.long()]

    active = pos_ok & (idx <= last[..., None])
    charge = torch.where(decision, p0_1, 0) + torch.where(
        nz, p1_1 + vcost + 256, p1_0)
    r = torch.where(active, charge, 0).sum(dim=-1, dtype=I32)

    # End-of-block: p0(...,0) at position last+1 (skipped when last==15),
    # or at `first` with ctx0 for an empty block.
    eob_pos = torch.clamp(torch.where(has, last + 1, first), first, 15)
    eob = torch.gather(p0_0, -1, eob_pos.long()[..., None])[..., 0]
    eob = torch.where(has & (last == 15), 0, eob)
    return r + eob


def mul_shr16(lam, rate):
    """Exact (lam * rate) >> 16 in int32 for 0 <= lam < 2^19.

    Split limbs keep every partial product below 2^30 for any rate below
    2^26 (lam*rh < 2^19·2^10, lh*rl < 2^11·2^16, ll*rl < 2^24).
    """
    lh, ll = lam >> 8, lam & 0xFF
    rh = rate >> 16
    rl = rate & 0xFFFF
    return lam * rh + ((lh * rl + ((ll * rl) >> 8)) >> 8)


__all__ = ["block_rate256", "mul_shr16", "position_tables",
           "rate_by_position"]
