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

``trellis_refine`` is the host encoder's trellis quantization (method 6)
on the same tables.
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


TRELLIS_INF = 1 << 60


def trellis_refine(lv, cf, p0_n, p1_n, val_n, *, first: int, ctx0: int,
                   dc_q, ac_q, lam):
    """Trellis quantization of blocks: each non-zero level l0 is kept or
    lowered to l0 - 1 (never to 0), by the least distortion + lam * token
    rate over the whole block, the rate being the exact token grammar's on
    the per-position tables (p0/p1 (16, 3, 2), val (16, 3, 68) of one
    token type), block_rate256's rules: the host encoder's
    trellis_refine, as a DP over positions vectorised over blocks.

    lv (R, 16) zigzag levels, cf (R, 16) the raster coefficients they
    quantize; dc_q, ac_q, lam (R,) int: the steps of position 0 and of the
    rest, and the rate weight.  Scores are int64 (distortion (|c| - v q)^2
    plus lam * rate in 1/256 bits); ties keep the unlowered level and the
    lower predecessor.  Returns the refined (R, 16) zigzag levels, int32.
    """
    from .dct import zigzag_fwd

    I64 = torch.int64
    dev = lv.device
    R = lv.shape[0]
    lv = lv.to(I64)
    nzm = lv != 0
    nzm[:, :first] = False
    # positions past every block's last non-zero change nothing
    end = int(torch.where(nzm, torch.arange(16, device=dev), -1).amax()) + 1 \
        if R else 0
    if end == 0:
        return lv.to(I32)
    araw = zigzag_fwd(cf.to(I64)).abs()
    v0 = lv.abs()
    q = torch.cat([dc_q.to(I64)[:, None],
                   ac_q.to(I64)[:, None].expand(R, 15)], 1)
    lam = lam.to(I64)[:, None]
    cand = torch.stack([v0, torch.where(v0 > 1, v0 - 1, 0)], -1)  # (R,16,2)
    dist = (araw[..., None] - cand * q[..., None]) ** 2
    vidx = cand.clamp_max(67)
    p01 = torch.stack([p0_n.to(I64).reshape(48, 2),
                       p1_n.to(I64).reshape(48, 2)], 1)          # (48, 2, 2)
    valf = val_n.to(I64).reshape(48, 68)
    INF = TRELLIS_INF
    # the state by the candidate at the last non-zero so far (a virtual
    # one at first - 1, context ctx0, starts the block): its score, the
    # context it leaves and the rate since it (continue bit, zero run)
    score = torch.full((R, 2), INF, dtype=I64, device=dev)
    score[:, 0] = 0
    nctx = torch.full((R, 2), ctx0, dtype=I64, device=dev)
    acc = torch.zeros((R, 2), dtype=I64, device=dev)
    nxt = torch.full((R, 1), first, dtype=I64, device=dev)  # last nz + 1
    back = torch.zeros((R, 16, 2), dtype=torch.bool, device=dev)
    cand1_ok = cand[..., 1] >= 1
    for n in range(first, end):
        nz = nzm[:, n, None]
        after = nxt == n
        row = 3 * n + torch.where(after, nctx, 0)              # (R, 2) by pc
        pp = p01[row]                                          # (R, 2, p, bit)
        acc = torch.where(after, pp[:, :, 0, 1], acc)
        # (R, cand, pc): the state pc's score and rate, the candidate's
        # value cost and distortion
        s = (score + (acc + pp[:, :, 1, 1] + 256) * lam)[:, None, :] \
            + valf[row[:, None, :], vidx[:, n, :, None]] * lam[..., None] \
            + dist[:, n, :, None]
        s = torch.where((score >= INF)[:, None, :], INF, s)
        pick1 = s[..., 1] < s[..., 0]
        new = torch.where(pick1, s[..., 1], s[..., 0])
        new[:, 1] = torch.where(cand1_ok[:, n], new[:, 1], INF)
        back[:, n] = pick1
        score = torch.where(nz, new, score)
        nctx = torch.where(nz, torch.where(cand[:, n] == 1, 1, 2), nctx)
        acc = torch.where(nz, acc, acc + pp[:, :, 1, 0])
        nxt = torch.where(nz, n + 1, nxt)
    # the end-of-block bit after the last non-zero, unless it is at 15
    eob = p01[3 * nxt.clamp_max(15) + nctx][:, :, 0, 0] * lam
    end_s = score + torch.where(nxt <= 15, eob, 0)
    end_s = torch.where(score >= INF, INF, end_s)
    cur = (end_s[:, 1] < end_s[:, 0]).to(I64)
    out = lv.clone()
    rows = torch.arange(R, device=dev)
    for n in range(end - 1, first - 1, -1):
        nz = nzm[:, n]
        level = cand[rows, n, cur]
        out[:, n] = torch.where(nz, torch.where(lv[:, n] < 0, -level, level),
                                out[:, n])
        cur = torch.where(nz, back[rows, n, cur].to(I64), cur)
    return out.to(I32)


def mul_shr16(lam, rate):
    """Exact (lam * rate) >> 16 in int32 for 0 <= lam < 2^19.

    Split limbs keep every partial product below 2^30 for any rate below
    2^26 (lam*rh < 2^19·2^10, lh*rl < 2^11·2^16, ll*rl < 2^24).
    """
    lh, ll = lam >> 8, lam & 0xFF
    rh = rate >> 16
    rl = rate & 0xFFFF
    return lam * rh + ((lh * rl + ((ll * rl) >> 8)) >> 8)


__all__ = ["TRELLIS_INF", "block_rate256", "mul_shr16", "position_tables",
           "rate_by_position", "trellis_refine"]
