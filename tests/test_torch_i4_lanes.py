"""PyTorch port: the lane layout of wavefront_search's in-loop i4 walk,
checked on CPU with plain torch models of the kernel's lanes.

- The token rate by position (``i4_lanes.cuh`` ``rate_lanes``: raster
  levels on the lanes, zigzag shuffle sources, the ballot's ``last``, the
  end-of-block lane) equals the serial grammar walk (``i4_score.cuh``
  ``rate_walk``), the port's ``rate_by_position`` and the JAX package's
  ``block_rate256``.
- The candidate map of a walk step (warp, segment, round) -> (sub-block,
  B-mode) covers every (sub-block, mode) of each diagonal once, one
  sub-block a warp, and every read of the scratch comes after its write.
- The (cost, mode) argmin across segments, as the least key
  cost << 4 | mode, keeps the first minimum, and every cost fits the key.
- The lean lane FDCT and IDCT (one weighted pair of butterfly inputs a
  lane) equal fdct4x4 and idct4x4, the IDCT's wrapping products included.
- A whole walk step scored the kernel's way (the lane rate, the segment
  argmin) equals ``i4_search_plain``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gowebp_tpu.models.vp8.encoder import _default_cost_tables
from gowebp_tpu.ops.rate_jax import block_rate256 as block_rate256_jax
from gowebp_tpu_torch.models.vp8.tables import ZIGZAG
from gowebp_tpu_torch.ops.dct import BIAS, fdct4x4, idct4x4, quantize
from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
from gowebp_tpu_torch.ops.kernels.i4_search import (MODE4_BITS256,
                                                    i4_search_plain)
from gowebp_tpu_torch.ops.rate import (block_rate256, mul_shr16,
                                       position_tables, rate_by_position)
from gowebp_tpu_torch.ops.vp8_recon import _pred_luma4_all

I32 = torch.int32
ZZ = [int(z) for z in ZIGZAG]


def _tables():
    return tuple(torch.from_numpy(t.astype(np.int32))
                 for t in _default_cost_tables())


def _zigzag_nibbles():
    """The kernel's kZigzagNibbles constant, read from its source."""
    text = (KERNEL_DIR / "i4_lanes.cuh").read_text()
    return int(re.search(r"kZigzagNibbles = (0x[0-9A-Fa-f]+)ull", text)[1], 16)


def zigzag_lane(n):
    return (_zigzag_nibbles() >> (4 * n)) & 15


def rate_positions_model(lz, lp, p0_n, p1_n, val_n, first):
    """rate_positions on (S, 16) lanes: lane n holds the levels of
    positions n (lz) and n - 1 (lp); a ballot of the non-zero positions
    from `first` on gives `last`; lane n in first..last charges its
    position, lane last + 1 the end of block."""
    n = torch.arange(16)
    nz = lz != 0
    ballot = nz & (n >= first)
    last = torch.where(ballot, n, first - 1).amax(-1, keepdim=True)
    v = lz.abs().clamp_max(67)
    ap = lp.abs()
    prev_nz = (n > first) & (ap != 0)
    ctx = torch.where(n == first, 1,
                      torch.where(prev_nz, torch.where(ap == 1, 1, 2), 0))
    row = (3 * n + ctx).long()
    p0 = p0_n.reshape(48, 2)[row]                     # (S, 16, 2)
    p1 = p1_n.reshape(48, 2)[row]
    val = val_n.reshape(-1)[row * 68 + v.long()]
    charge = torch.where((n == first) | prev_nz, p0[..., 1], 0) + torch.where(
        nz, p1[..., 1] + val + 256, p1[..., 0])
    active = (n >= first) & (n <= last)
    lane = torch.where(active, charge, torch.where(n == last + 1, p0[..., 0],
                                                   0))
    return lane.sum(-1, dtype=I32)


def rate_lanes_model(raster, p0_n, p1_n, val_n, first):
    """rate_lanes on (S, 16) raster levels, one row per segment: lane n
    takes position n's level from lane zigzag_lane(n) and position n-1's
    from lane zigzag_lane(n - 1)."""
    raster = raster.to(I32)
    here = torch.tensor([zigzag_lane(i) for i in range(16)])
    before = torch.tensor([zigzag_lane(max(i - 1, 0)) for i in range(16)])
    return rate_positions_model(raster[:, here], raster[:, before], p0_n,
                                p1_n, val_n, first)


def rate_zigzag_model(zz, p0_n, p1_n, val_n, first):
    """rate_zigzag on (S, 16) zigzag levels: lane n loads positions n and
    n - 1 (position 0 again at n = 0)."""
    zz = zz.to(I32)
    before = torch.tensor([max(i - 1, 0) for i in range(16)])
    return rate_positions_model(zz, zz[:, before], p0_n, p1_n, val_n, first)


def rate_walk_model(zz, p0_n, p1_n, val_n, first):
    """i4_score.cuh rate_walk, serially, on one block's zigzag levels."""
    p0 = p0_n.reshape(48, 2).tolist()
    p1 = p1_n.reshape(48, 2).tolist()
    val = val_n.reshape(48, 68).tolist()
    nzpos = [n for n in range(first, 16) if zz[n] != 0]
    last = nzpos[-1] if nzpos else -1
    r, prev_v, prev_nz = 0, 0, False
    for n in range(first, last + 1):
        v = min(abs(zz[n]), 67)
        nz = zz[n] != 0
        ctx = 1 if n == first else ((1 if prev_v == 1 else 2) if prev_nz
                                    else 0)
        row = 3 * n + ctx
        if n == first or prev_nz:
            r += p0[row][1]
        r += p1[row][1] + val[row][v] + 256 if nz else p1[row][0]
        prev_nz, prev_v = nz, v
    if last < 0:
        return r + p0[3 * first + 1][0]
    if last == 15:
        return r
    return r + p0[3 * (last + 1) + (1 if prev_v == 1 else 2)][0]


def _rate_cases(seed, S=600):
    """Zigzag levels: mostly zeros and small values with some above 67;
    empty blocks, blocks that end at 15, blocks whose only non-zero is
    position 0, runs of zeros between values of 1 and above."""
    rng = np.random.default_rng(seed)
    vals = rng.choice([0, 0, 0, 1, -1, 2, -3, 5, 67, -68, 300, -2047], (S, 16))
    keep = rng.random((S, 1)) < rng.random((S, 16))
    zz = np.where(keep, vals, 0)
    zz[:40] = 0                                       # empty
    zz[40:80, 15] = rng.choice([1, -1, 2, 70], 40)     # last == 15
    zz[80:100] = 0
    zz[80:100, 0] = rng.choice([1, -4], 20)           # only the DC
    zz[100:120] = np.tile([1, 0, 2, 0, 0, -1, 1, 3, 0, 68, -1, 0, 0, 0,
                           1, 0], (20, 1))            # every transition
    return torch.from_numpy(zz.astype(np.int32))


@pytest.mark.parametrize("type_,first", [(3, 0), (0, 1), (1, 0), (2, 0)])
@pytest.mark.parametrize("seed", [1, 2])
def test_rate_lanes_equal_the_serial_walk(type_, first, seed):
    tables = _tables()
    p0_n, p1_n, val_n = position_tables(tables, type_)
    zz = _rate_cases(seed)
    raster = torch.zeros_like(zz)
    raster[:, ZZ] = zz                                # position n -> lane ZZ[n]
    got = rate_lanes_model(raster, p0_n, p1_n, val_n, first)
    want = [rate_walk_model(z, p0_n, p1_n, val_n, first) for z in zz.tolist()]
    assert got.tolist() == want
    assert torch.equal(rate_zigzag_model(zz, p0_n, p1_n, val_n, first), got)
    assert torch.equal(got, rate_by_position(zz, p0_n, p1_n, val_n,
                                             first=first, ctx0=1))
    assert torch.equal(got, block_rate256(zz, tables, type=type_,
                                          first=first, ctx0=1))
    jax_rate = block_rate256_jax(jnp.asarray(zz.numpy()),
                                 tuple(jnp.asarray(t.numpy()) for t in tables),
                                 type=type_, first=first, ctx0=1)
    assert got.tolist() == np.asarray(jax_rate).tolist()
    # the cases reach every context of a charged position, empty blocks
    # and blocks that end at 15
    nzp = zz[:, :-1] != 0
    assert (zz[:, 1:][~nzp] == 0).any() and (zz[:, 1:][~nzp] != 0).any()
    assert (zz[:, :-1].abs() == 1).any() and (zz[:, :-1].abs() > 67).any()
    assert (zz[:, first:] == 0).all(-1).any() and (zz[:, 15] != 0).any()


# ---- the lean lane transforms ----

def _lane_consts(text, name):
    """{o: (s, w1, w2, w3, sh)} of i4_lanes.cuh's FdctPass table `name`."""
    body = re.search(name + r"\(int o\) \{.*?\n\}", text, re.S)[0]
    rows = re.findall(r"FdctPass\{([^}]*)\}", body)
    return {o: tuple(int(v) for v in r.split(",")) for o, r in enumerate(rows)}


def fdct_lean_model(res):
    """fdct_lean on (S, 16) raster residuals: lane (i, j) takes P = d0 +
    s d3, Q = d1 + s d2 of its row (then column) and returns (P w1 + Q w2 +
    w3) >> sh, plus (P != 0) in output row 1."""
    text = (KERNEL_DIR / "i4_lanes.cuh").read_text()
    row, col = (_lane_consts(text, "fdct_row_pass"),
                _lane_consts(text, "fdct_col_pass"))
    x = res.to(I32).reshape(-1, 4, 4)
    t = torch.empty_like(x)
    for i in range(4):
        for j in range(4):
            sg, w1, w2, w3, sh = row[j]
            d = x[:, i, :]
            P, Q = d[:, 0] + sg * d[:, 3], d[:, 1] + sg * d[:, 2]
            t[:, i, j] = (P * w1 + Q * w2 + w3) >> sh
    out = torch.empty_like(x)
    for i in range(4):
        for j in range(4):
            sg, w1, w2, w3, sh = col[i]
            d = t[:, :, j]
            P, Q = d[:, 0] + sg * d[:, 3], d[:, 1] + sg * d[:, 2]
            out[:, i, j] = ((P * w1 + Q * w2 + w3) >> sh) + (
                (P != 0) & (i == 1)).to(I32)
    return out


def _mul1(a):
    return a + ((a * 20091) >> 16)                   # int32: wraps as wmul


def _mul2(a):
    return (a * 35468) >> 16


def idct_lean_model(cf):
    """idct_lean on (S, 4, 4) dequantized coefficients: output o of a pass
    is (d0 +- d2) +- mul1(X) +- mul2(Y), X, Y = d1, d3 for o = 0, 3 and
    d3, d1 for o = 1, 2."""
    def out(d, o):
        x = o in (0, 3)
        s0 = 1 if x else -1
        sa = 1 if o in (0, 2) else -1
        sb = 1 if o <= 1 else -1
        X, Y = (d[:, 1], d[:, 3]) if x else (d[:, 3], d[:, 1])
        return d[:, 0] + s0 * d[:, 2] + sa * _mul1(X) + sb * _mul2(Y)

    x = cf.to(I32)
    t = torch.empty_like(x)
    for i in range(4):
        for j in range(4):
            t[:, i, j] = out(x[:, :, j], i)           # column j, output row i
    res = torch.empty_like(x)
    for i in range(4):
        for j in range(4):
            d = t[:, i, :].clone()
            d[:, 0] += 4
            res[:, i, j] = out(d, j) >> 3             # row i, output column j
    return res


@pytest.mark.parametrize("seed", [1, 2])
def test_lean_transforms_equal_the_plain_ones(seed):
    """fdct_lean and idct_lean give fdct4x4's and idct4x4's values: the
    residuals of 8-bit pixels, and dequantized levels up to 2047 x 157,
    where the IDCT's products wrap modulo 2^32."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-255, 256, (3000, 4, 4))
    res[:8] = [[255, -255, 255, -255]] * 4            # extremes
    res[8:16] = 0
    res = torch.from_numpy(res.astype(np.int32))
    assert torch.equal(fdct_lean_model(res.reshape(-1, 16)), fdct4x4(res))
    lv = rng.integers(-2047, 2048, (3000, 4, 4)) * rng.integers(
        1, 158, (3000, 1, 1))
    lv[::3] //= 97                                    # small values too
    lv[:4] = 2047 * 157
    cf = torch.from_numpy(lv.astype(np.int32))
    assert (cf.abs() * 35468 > 2 ** 31).any()         # wrapping products
    assert torch.equal(idct_lean_model(cf), idct4x4(cf))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_i16_rate_by_segments_equals_the_serial_rates(seed):
    """The kernel's i16 rate: segment h charges AC blocks 8h .. 8h + 7
    (type 0 from position 1), segment 0 also the Y2 block (type 1, from
    position 0), from the zigzag levels in shared memory; the sum of both
    segments is the serial walks' sum."""
    text = (KERNEL_DIR / "wavefront_search.cu").read_text()
    assert "vp8::rate_zigzag<8, 1>(s_lv + 128 * half, k, T[0], ac);" in text
    assert "vp8::rate_zigzag<1, 0>(s_lv + 384, k, T[1], y2);" in text
    assert "int r = half == 0 ? y2[0] : 0;" in text
    tables = _tables()
    t0, t1 = position_tables(tables, 0), position_tables(tables, 1)
    for mb in _rate_cases(seed, S=17 * 30).reshape(30, 17, 16):
        ac, y2 = mb[:16].clone(), mb[16:]
        ac[:, 0] = 0                                  # i16 AC blocks: no DC
        seg = [rate_zigzag_model(ac[8 * h:8 * h + 8], *t0, 1).sum()
               for h in range(2)]
        got = int(seg[0] + seg[1] + rate_zigzag_model(y2, *t1, 0)[0])
        want = sum(rate_walk_model(b, *t0, 1) for b in ac.tolist())
        want += rate_walk_model(y2[0].tolist(), *t1, 0)
        assert got == want


def test_zigzag_nibbles_invert_the_kernels_inverse():
    """zigzag_lane(n) is the raster lane of zigzag position n, and undoes
    vp8_dsp.cuh's inv_zigzag."""
    text = (KERNEL_DIR / "vp8_dsp.cuh").read_text()
    inv = int(re.search(r"kInvZigzagNibbles = (0x[0-9A-Fa-f]+)ull", text)[1],
              16)
    assert [zigzag_lane(n) for n in range(16)] == ZZ
    assert [(inv >> (4 * zigzag_lane(n))) & 15 for n in range(16)] == list(
        range(16))


def test_mode_bits_constant_is_the_table():
    """i4_lanes.cuh's mode4_bits (5 bits a mode, in 64ths) gives
    vp8_dsp.cuh's kMode4Bits256 and the port's MODE4_BITS256."""
    text = (KERNEL_DIR / "i4_lanes.cuh").read_text()
    packed = int(re.search(r"kMode4Bits64ths = (0x[0-9A-Fa-f]+)ull", text)[1],
                 16)
    table = re.search(r"kMode4Bits256\[10\] = \{([^}]*)\}",
                      (KERNEL_DIR / "vp8_dsp.cuh").read_text())[1]
    got = [((packed >> (5 * m)) & 31) << 6 for m in range(10)]
    assert got == [int(v) for v in table.split(",")] == list(MODE4_BITS256)


# ---- the walk step's candidate map ----

LUMA_WARPS = (0, 2)


def kernel_step_slots(d):
    """{(warp, segment, round): (gy, gx, mode)} of walk step d, as
    wavefront_search.cu assigns them: warp w takes sub-block gy0 + w/2 of
    the diagonal (warp 2 only on diagonals 2-7, which hold two), segment
    h scores modes 5h + round (5 rounds)."""
    two = 2 <= d <= 7
    out = {}
    for warp in LUMA_WARPS:
        if warp == 2 and not two:
            continue
        gy = (0 if d < 3 else (d - 2) >> 1) + (warp >> 1)
        gx = d - 2 * gy
        for half in range(2):
            for j in range(5):
                out[(warp, half, j)] = (gy, gx, 5 * half + j)
    return out


def kernel_barrier_before(d):
    """Whether both luma warps meet at a barrier before walk step d (warp
    0 alone orders its own steps with __syncwarp)."""
    return 2 <= d <= 8


def test_step_map_is_the_kernels():
    text = (KERNEL_DIR / "wavefront_search.cu").read_text()
    for line in (
            "const bool two = dg >= 2 && dg <= 7;",
            "if (dg >= 2 && dg <= 8)\n              vp8::named_barrier_luma();",
            "if (warp == 2 && !two) continue;",
            "const int gy = (dg < 3 ? 0 : (dg - 2) >> 1) + (warp >> 1), "
            "gx = dg - 2 * gy;",
            "vp8::score_lanes<5>(s_pent, 5 * half, k,",
            "const int best = min(ks, __shfl_xor_sync(vp8::kFullMask, ks, 16));"):
        assert line in text, line


@pytest.mark.parametrize("d", range(10))
def test_step_map_covers_each_candidate_once(d):
    got = list(kernel_step_slots(d).values())
    want = [(gy, gx, m) for gy in range(4) for gx in range(4)
            if 2 * gy + gx == d for m in range(10)]
    assert len(got) == len(set(got))
    assert sorted(got) == sorted(want)
    assert len(want) in (10, 20)
    # each warp scores one sub-block whole: its argmin needs no other warp
    slots = kernel_step_slots(d)
    for warp in LUMA_WARPS:
        assert len({c[:2] for (w, _, _), c in slots.items() if w == warp}) <= 1


def test_step_map_orders_every_read_after_its_write():
    """A sub-block reads its left, top, top-left and top-right neighbours'
    recon (gx < 3): each is written on an earlier step by the same warp
    (program order) or by the other warp with a barrier in between."""
    writer = {}                                       # (gy, gx) -> (step, warp)
    for d in range(10):
        for (warp, _, _), (gy, gx, _) in kernel_step_slots(d).items():
            writer[(gy, gx)] = (d, warp)
    assert len(writer) == 16
    for (gy, gx), (d, warp) in writer.items():
        deps = [(gy, gx - 1), (gy - 1, gx), (gy - 1, gx - 1)]
        if gx < 3:
            deps.append((gy - 1, gx + 1))
        for dep in deps:
            if dep not in writer:
                continue                              # the MB's border
            d0, w0 = writer[dep]
            assert d0 < d
            if w0 != warp:
                assert any(kernel_barrier_before(e)
                           for e in range(d0 + 1, d + 1))
    # both warps meet the same 7 barriers: warp 2 skips its steps after them
    assert sum(kernel_barrier_before(d) for d in range(10)) == 7


# ---- the argmin across a step's segments ----

KEY_LIMIT = torch.iinfo(torch.int32).max


def key_argmin_model(cost):
    """The kernel's argmin of one sub-block's (S, 10) costs: segment h
    holds modes 5h .. 5h + 4, every candidate's key is cost << 4 | mode,
    and the least key of each segment, then of the two segments, wins.
    Returns (mode, cost)."""
    S = cost.shape[0]
    keys = cost.to(torch.int64) * 16 + torch.arange(10)
    assert int(keys.max()) <= KEY_LIMIT                 # int32 keys
    best = keys.reshape(S, 2, 5).amin(-1).amin(-1)
    return best & 15, best >> 4


def _first_min(cost):
    rows = cost.tolist()
    modes = [r.index(min(r)) for r in rows]
    return torch.tensor(modes), torch.tensor([min(r) for r in rows])


@pytest.mark.parametrize("high", [4, 2, 1, 2 ** 22])
def test_key_argmin_keeps_the_first_minimum(high):
    rng = np.random.default_rng(high)
    cost = torch.from_numpy(rng.integers(1, high + 1, (500, 10)).astype(
        np.int32))
    cost[0] = 7                                       # all ten tie
    cost[1, [2, 7]] = 0                               # a tie across segments
    cost[2, [6, 8]] = 0                               # a tie in segment 1
    cost[3, [0, 1]] = 0                               # a tie in segment 0
    mode, best = key_argmin_model(cost)
    want_mode, want_best = _first_min(cost)
    assert torch.equal(mode, want_mode)
    assert torch.equal(best, want_best)
    assert mode[:4].tolist() == [0, 2, 6, 0]


def test_costs_fit_the_key():
    """Every RD cost of a candidate is below 2^22, so cost << 4 | mode is
    an int32 key: SSE <= 16 * 255^2, the rate of 16 charged positions at
    the tables' largest p0 + p1 + value + sign terms (or 15 and an
    end-of-block) plus the largest mode cost, weighted by a penalty below
    2^19 (the wrapper's bound)."""
    p0, p1, val = _tables()
    per_pos = int(p0.max() + p1.max() + val.max() + 256)
    rate = max(16 * per_pos, 15 * per_pos + int(p0.max())) + max(MODE4_BITS256)
    cost = 16 * 255 ** 2 + int(mul_shr16(torch.tensor((1 << 19) - 1),
                                         torch.tensor(rate)))
    assert rate < 2 ** 18 and cost < 2 ** 22
    assert (cost << 4 | 15) < KEY_LIMIT


# ---- one walk step scored the kernel's way ----

@pytest.mark.parametrize("quality_q,seed", [(30, 1), (60, 2), (110, 3)])
def test_step_scored_by_lanes_equals_plain_search(quality_q, seed):
    """Every candidate's cost from the lane rate (raster levels, zigzag
    shuffles, ballot) and the segment argmin give i4_search_plain's mode,
    cost and recon, on flat (tie-heavy) and noisy sub-blocks."""
    from gowebp_tpu_torch.models.vp8.encoder import make_quants

    rng = np.random.default_rng(seed)
    S = 400
    ctx = rng.integers(0, 256, (S, 13))
    src = rng.integers(0, 256, (S, 16))
    ctx[:100] = 128                                   # flat: modes tie
    src[:100] = 128 + rng.integers(-1, 2, (100, 1))
    q = make_quants(quality_q)
    pen = rng.integers(0, 1 << 18, S)
    pen[:50] = 0                                      # ties on SSE alone
    quants5 = np.stack([np.full(S, (1 << 17) // q.y1_dc.q),
                        np.full(S, (1 << 17) // q.y1_ac.q),
                        np.full(S, q.y1_dc.q), np.full(S, q.y1_ac.q), pen], 1)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    ctx13, src16, quants5 = t(ctx), t(src), t(quants5)
    tables = _tables()
    t3 = position_tables(tables, 3)
    want_mode, want_cost, want_rec = i4_search_plain(ctx13, src16, quants5, t3)

    preds = _pred_luma4_all(ctx13[:, 0], ctx13[:, 1:5], ctx13[:, 5:9],
                            ctx13[:, 9:13])          # (S, 10, 4, 4)
    s = src16.reshape(S, 1, 4, 4)
    cf = fdct_lean_model((s - preds).reshape(S * 10, 16)).reshape(S, 10, 4, 4)
    lv = quantize(cf, quants5[:, 0:1], BIAS["y1_dc"], quants5[:, 1:2],
                  BIAS["y1_ac"])                    # zigzag (S, 10, 16)
    raster = torch.zeros_like(lv)
    raster[..., ZZ] = lv
    rate = rate_lanes_model(raster.reshape(S * 10, 16), *t3, 0).reshape(S, 10)
    deq = raster * torch.where(torch.arange(16) == 0, quants5[:, 2:3],
                               quants5[:, 3:4])[:, None]
    rec = (preds + idct_lean_model(deq.reshape(S * 10, 4, 4)).reshape(
        S, 10, 4, 4)).clamp(0, 255)
    dist = ((s - rec) ** 2).sum((-1, -2), dtype=I32)
    cost = dist + mul_shr16(quants5[:, 4:5],
                            rate + torch.tensor(MODE4_BITS256, dtype=I32))
    mode, best = key_argmin_model(cost)
    assert torch.equal(mode.to(I32), want_mode)
    assert torch.equal(best.to(I32), want_cost)
    assert torch.equal(rec[torch.arange(S), mode].reshape(S, 16).to(
        torch.uint8), want_rec)
    assert (cost[:100] == cost[:100, :1]).sum() > 100  # ties were there
