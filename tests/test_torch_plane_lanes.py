"""PyTorch port: the lane arithmetic of the open-loop plane kernels
(``ops/kernels/encode_plane.cu``), checked on CPU with plain numpy models
of one lane's work.

- The loads: aligned 32-bit words funnel-shifted by the image's byte
  offset give each lane's source rows and the MB's top row, and the byte
  loads its left column and corner, with the edge fills: they equal the
  planes and ``mb_context``, for planes at any base offset and batch
  stride.
- The mode SSEs as sum(s^2) - 2 sum(s p) + sum(p^2) from dp4a's of packed
  bytes, with the TM rows built as clamped 16-bit pairs, reduced over an
  MB's lanes (luma; chroma jointly over U and V), equal the direct SSEs of
  ``predict4_blocks``; the first minimum equals ``_search``'s mode, and
  the residual from the chosen row words equals ``_search``'s.
- The TM pairs equal clip8(left + top - tl) for every top and left.
- The Y2 butterfly (``vp8_dsp.cuh`` ``fwht_lane``: two segment-shuffle
  passes, one coefficient a lane) equals ``dct.fwht4x4`` and the JAX WHT,
  DC extremes included.

The constants the models use (byte-permute selectors, clamp bounds) are
read back from the kernel source.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gowebp_tpu.ops import dct_jax
from gowebp_tpu_torch.ops import dct
from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
from gowebp_tpu_torch.ops.kernels.encode_plane import _search
from gowebp_tpu_torch.ops.vp8_recon import mb_context, predict4_blocks

M32 = np.uint64(0xFFFFFFFF)
ONES = 0x01010101
SOURCE = (KERNEL_DIR / "encode_plane.cu").read_text()


def _in_source(snippet: str) -> str:
    assert snippet in SOURCE, f"encode_plane.cu no longer has {snippet!r}"
    return snippet


def _hex(name_pattern: str) -> int:
    """The hex literal that follows ``name_pattern`` in the source."""
    return int(re.search(name_pattern + r"\s*(0x[0-9A-Fa-f]+)u", SOURCE)[1], 16)


# the selectors and bounds of block_sse, read from the kernel
SEL_LO = _hex(r"__byte_perm\(k\.top, 0u,")
SEL_HI = int(re.findall(r"__byte_perm\(k\.top, 0u, (0x[0-9A-Fa-f]+)u\)",
                        SOURCE)[1], 16)
SEL_PACK = _hex(r"0x01FF01FFu\),\s*")
CLAMP_LO, CLAMP_HI = (int(x, 16) for x in re.search(
    r"clamp_u16x2\(d_lo \+ l2, (0x[0-9A-Fa-f]+)u, (0x[0-9A-Fa-f]+)u\)",
    SOURCE).groups())
_in_source("(unsigned)(256 - k.tl) * 0x10001u")
_in_source("sse[0] = ss + dc * (16 * dc - 2 * sum);")


def u64(x):
    return np.asarray(x).astype(np.uint64)


def prmt(x, y, sel):
    """__byte_perm: byte i of the result is byte (sel >> 4i) & 7 of the
    8 bytes y:x."""
    b = (u64(y) << np.uint64(32)) | u64(x)
    out = np.zeros(b.shape, np.uint64)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        out |= ((b >> np.uint64(8 * s)) & np.uint64(255)) << np.uint64(8 * i)
    return out


def dp4a(a, b, c=0):
    """__dp4a of unsigned bytes."""
    a, b = u64(a), u64(b)
    acc = np.asarray(c).astype(np.int64)
    for i in range(4):
        sh = np.uint64(8 * i)
        acc = acc + ((a >> sh) & np.uint64(255)).astype(np.int64) * (
            (b >> sh) & np.uint64(255)).astype(np.int64)
    return acc


def clamp_u16x2(x, lo, hi):
    """max.u16x2 then min.u16x2 on each 16-bit half."""
    x = u64(x)
    out = np.zeros(x.shape, np.uint64)
    for sh in (0, 16):
        s = np.uint64(sh)
        h = (x >> s) & np.uint64(0xFFFF)
        h = np.minimum(np.maximum(h, np.uint64((lo >> sh) & 0xFFFF)),
                       np.uint64((hi >> sh) & 0xFFFF))
        out |= u64(h) << s
    return out


def funnelshift_r(lo, hi, shift):
    return ((u64(hi) << np.uint64(32)) | u64(lo)) >> u64(shift) & M32


def byte_of(w, c):
    return ((u64(w) >> np.uint64(8 * c)) & np.uint64(255)).astype(np.int64)


def word(buf, addr):
    """The little-endian 32-bit word at byte address addr (4-aligned)."""
    assert not (np.asarray(addr) & 3).any()
    return sum(u64(buf[addr + i]) << np.uint64(8 * i) for i in range(4))


def lane_loads(buf, img_addr, H, W, size):
    """load_block for every lane of every MB: the planes are (H, W) uint8
    at byte addresses img_addr (B,) of the flat buffer (whose address 0
    is 4-byte aligned).  Returns rows (B, mh, mw, nb, nb, 4) words, top
    (B, mh, mw, nb, nb) words, left (..., 4) and tl (B, mh, mw, 1, 1)."""
    mh, mw, nb = H // size, W // size, size // 4
    img = np.asarray(img_addr, np.int64).reshape(-1, 1, 1, 1, 1)
    a = img & 3
    base, shift = img - a, 8 * a
    my = np.arange(mh).reshape(1, -1, 1, 1, 1)
    mx = np.arange(mw).reshape(1, 1, -1, 1, 1)
    by = np.arange(nb).reshape(1, 1, 1, -1, 1)
    bx = np.arange(nb).reshape(1, 1, 1, 1, -1)
    r0, c0 = my * size + by * 4, mx * size + bx * 4
    ht, hl = my > 0, mx > 0

    def load4(w):
        hi = np.where(a != 0, word(buf, w + 4 * (a != 0)), 0)
        return funnelshift_r(word(buf, w), hi, shift)

    rows = np.stack([load4(base + (r0 + r) * W + c0) for r in range(4)], -1)
    above = (my * size - 1) * W
    top = np.where(ht, load4(base + np.where(ht, above, 0) + c0),
                   0x7F7F7F7F).astype(np.uint64)
    c_left = mx * size - 1
    left = np.stack([np.where(hl, buf[img + (r0 + i) * W + np.maximum(c_left, 0)],
                              129) for i in range(4)], -1).astype(np.int64)
    tl = np.where(~ht, 127, np.where(~hl, 129, buf[img + np.maximum(above, 0)
                                                   + np.maximum(c_left, 0)]))
    return rows, top, left, tl.astype(np.int64), ht, hl


def wire_buffer(rng, B, H, W, offset, stride):
    """B planes of (H, W) random bytes in one flat buffer, the first at
    byte `offset`, the next each `stride` bytes on → (buf, addresses,
    planes (B, H, W))."""
    buf = rng.integers(0, 256, offset + stride * B + 8).astype(np.uint8)
    addr = offset + stride * np.arange(B)
    planes = np.stack([buf[s:s + H * W].reshape(H, W) for s in addr])
    return buf, addr, planes


def dc_whole(sum_top, sum_left, ht, hl, size):
    shift = 5 if size == 16 else 4
    return np.where(ht & hl, (sum_top + sum_left + size) >> shift,
                    np.where(hl, (sum_left + size // 2) >> (shift - 1),
                             np.where(ht, (sum_top + size // 2) >> (shift - 1),
                                      0x80)))


def lane_sse(rows, top, left, tl, dc):
    """block_sse of every lane → (sse (4, ...) per lane, TM row words
    (..., 4))."""
    off = u64((256 - tl) * 0x10001)
    d_lo = prmt(top, 0, SEL_LO) + off
    d_hi = prmt(top, 0, SEL_HI) + off
    ss = sp_tm = pp_tm = sp_ve = sp_he = pp_he = 0
    rs, tm = [], []
    for r in range(4):
        s = rows[..., r]
        l2 = u64(left[..., r] * 0x10001)
        t = prmt(clamp_u16x2(d_lo + l2, CLAMP_LO, CLAMP_HI),
                 clamp_u16x2(d_hi + l2, CLAMP_LO, CLAMP_HI), SEL_PACK)
        tm.append(t)
        ss = dp4a(s, s, ss)
        rs.append(dp4a(s, ONES))
        sp_tm = dp4a(s, t, sp_tm)
        pp_tm = dp4a(t, t, pp_tm)
        sp_ve = dp4a(s, top, sp_ve)
        sp_he = sp_he + left[..., r] * rs[r]
        pp_he = pp_he + left[..., r] * left[..., r]
    total = sum(rs)
    sse = np.stack([ss + dc * (16 * dc - 2 * total),
                    ss - 2 * sp_tm + pp_tm,
                    ss - 2 * sp_ve + 4 * dp4a(top, top),
                    ss - 2 * sp_he + 4 * pp_he])
    return sse, np.stack(tm, -1)


def lane_model(planes_lanes, size):
    """The kernel's search on each plane's lanes (several planes share
    the MB grid: chroma's U and V): per MB SSEs (4, B, mh, mw), modes,
    and each plane's residual blocks (B, N, nb*nb, 4, 4)."""
    nb = size // 4
    sse, parts = 0, []
    for rows, top, left, tl, ht, hl in planes_lanes:
        # the MB's DC: the top sums over the block columns, the left sums
        # over the block rows (the xor_sum reductions)
        sum_top = dp4a(top, ONES).sum(axis=4, keepdims=True)
        sum_left = left.sum(-1).sum(axis=3, keepdims=True)
        dc = dc_whole(sum_top, sum_left, ht, hl, size)
        s, tm = lane_sse(rows, top, left, tl, dc)
        sse = sse + s.sum(axis=(4, 5))
        parts.append((rows, top, left, dc, tm))
    sse4 = sse                                           # (4, B, mh, mw)
    mode = np.zeros(sse4.shape[1:], np.int64)
    best = sse4[0]
    for m in range(1, 4):
        better = sse4[m] < best
        mode = np.where(better, m, mode)
        best = np.where(better, sse4[m], best)
    res = []
    md = mode[..., None, None, None]
    for rows, top, left, dc, tm in parts:
        p = np.where(md == 0, u64(dc * ONES)[..., None],
                     np.where(md == 1, tm,
                              np.where(md == 2, top[..., None],
                                       u64(left * ONES))))
        p = np.broadcast_to(p, rows.shape)
        r = np.stack([byte_of(rows, c) - byte_of(p, c) for c in range(4)], -1)
        B, mh, mw = r.shape[:3]
        res.append(r.reshape(B, mh * mw, nb * nb, 4, 4))
    return sse4, mode, res


def direct_sse(planes, size):
    """Per-MB SSEs (4, B, mh, mw) from mb_context and predict4_blocks."""
    sse = 0
    for p in planes:
        p = torch.from_numpy(p.astype(np.int32))
        B, H, W = p.shape
        mh, mw = H // size, W // size
        top, _, left, tl, ht, hl = mb_context(p, mh, mw, size)
        pred = predict4_blocks(top, left, tl, ht, hl, size)
        src = p.reshape(B, mh, size, mw, size).permute(0, 1, 3, 2, 4)
        d = src.reshape(B, mh * mw, size, size)[None] - pred
        sse = sse + (d * d).sum(dim=(-1, -2)).reshape(4, B, mh, mw)
    return sse.numpy()


@pytest.mark.parametrize("offset,stride_pad", [(0, 0), (1, 3), (2, 2),
                                               (3, 1), (1, 0)])
@pytest.mark.parametrize("size", [16, 8])
def test_loads_give_planes_and_mb_context(size, offset, stride_pad):
    """Any base offset and batch stride: the funnel-shifted words are the
    source rows, the top words and the left/corner bytes are
    mb_context's."""
    rng = np.random.default_rng(offset * 10 + stride_pad + size)
    B, H, W = 3, 3 * size, 5 * size
    buf, addr, planes = wire_buffer(rng, B, H, W, offset,
                                    H * W + stride_pad)
    rows, top, left, tl, ht, hl = lane_loads(buf, addr, H, W, size)
    mh, mw, nb = H // size, W // size, size // 4
    # rows: byte c of word r of lane (by, bx) is pixel (r0 + r, c0 + c)
    px = np.stack([byte_of(rows, c) for c in range(4)], -1)
    src = planes.reshape(B, mh, nb, 4, mw, nb, 4).transpose(0, 1, 4, 2, 5, 3, 6)
    np.testing.assert_array_equal(px, src)
    t = torch.from_numpy(planes.astype(np.int32))
    ctop, _, cleft, ctl, _, _ = mb_context(t, mh, mw, size)
    ctop = ctop.numpy().reshape(B, mh, mw, nb, 4)
    cleft = cleft.numpy().reshape(B, mh, mw, nb, 4)
    tops = np.stack([byte_of(top, c) for c in range(4)], -1)
    np.testing.assert_array_equal(
        tops, np.broadcast_to(ctop[:, :, :, None], tops.shape))
    np.testing.assert_array_equal(
        left, np.broadcast_to(cleft[:, :, :, :, None], left.shape))
    np.testing.assert_array_equal(
        np.broadcast_to(tl, (B, mh, mw, 1, 1))[..., 0, 0],
        ctl.numpy().reshape(B, mh, mw))


def _kind(rng, kind, shape):
    B, H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "random":
        return rng.integers(0, 256, shape)
    if kind == "flat":
        return np.full(shape, 200)
    if kind == "checkerboard":
        return np.broadcast_to(((yy + xx) & 1) * 255, shape)
    if kind == "extremes":                   # 0/255 MBs: TM clamps both ways
        return np.broadcast_to(((yy // 16 + xx // 16) & 1) * 255, shape)
    return np.broadcast_to((40 + 150 * xx / W + 60 * yy / H).astype(int),
                           shape)


@pytest.mark.parametrize("kind", ["random", "flat", "checkerboard",
                                  "extremes", "gradient"])
@pytest.mark.parametrize("size", [16, 8])
def test_lane_sse_modes_and_residual_equal_search(size, kind):
    rng = np.random.default_rng(size + len(kind))
    B, H, W = 2, 3 * size, 5 * size
    n_planes = 1 if size == 16 else 2
    lanes, planes = [], []
    for i in range(n_planes):
        p = np.ascontiguousarray(_kind(rng, kind, (B, H, W))).astype(np.uint8)
        if kind == "random" and i:
            p = 255 - p
        buf = p.reshape(-1)
        addr = np.arange(B) * H * W
        lanes.append(lane_loads(buf, addr, H, W, size))
        planes.append(p)
    sse, mode, res = lane_model(lanes, size)
    np.testing.assert_array_equal(sse, direct_sse(planes, size))
    want_mode, want_res = _search([torch.from_numpy(p) for p in planes], size)
    np.testing.assert_array_equal(mode.reshape(B, -1), want_mode.numpy())
    for got, want in zip(res, want_res):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("tl", [0, 1, 127, 128, 129, 254, 255])
def test_tm_pairs_equal_clip(tl):
    """Every top pair and left value: the clamped pairs' low bytes are
    clip8(left + top - tl)."""
    t = np.arange(256)
    t0, t1, left = np.meshgrid(t, t[::-1][::17], t, indexing="ij")
    top = u64(t0) | (u64(t1) << np.uint64(8))
    d_lo = prmt(top, 0, SEL_LO) + u64((256 - tl) * 0x10001)
    got = prmt(clamp_u16x2(d_lo + u64(left * 0x10001), CLAMP_LO, CLAMP_HI),
               0, SEL_PACK)
    for c, tc in enumerate((t0, t1)):
        np.testing.assert_array_equal(byte_of(got, c),
                                      np.clip(left + tc - tl, 0, 255))


def _wht4(x0, x1, x2, x3, o):
    a0, a1, a2, a3 = x0 + x3, x1 + x2, x1 - x2, x0 - x3
    return np.select([o == 0, o == 1, o == 2], [a0 + a1, a3 + a2, a0 - a1],
                     a3 - a2)


def fwht_lanes_model(dc):
    """fwht_lane on (..., 16) lanes, lane k holding block k's DC:
    seg_get(v, i) reads lane i of the segment."""
    k = np.arange(16)
    i, j = k >> 2, k & 3
    t = _wht4(dc[..., 4 * i], dc[..., 4 * i + 1], dc[..., 4 * i + 2],
              dc[..., 4 * i + 3], j)
    return _wht4(t[..., j], t[..., 4 + j], t[..., 8 + j], t[..., 12 + j],
                 i) >> 1


def test_y2_butterfly_equals_fwht():
    _in_source("vp8::fwht_lane(cf[0], blk)")
    rng = np.random.default_rng(9)
    ext = 2040                       # |DC| of a 4x4 FDCT of 8-bit residuals
    dcs = np.concatenate([
        rng.integers(-ext, ext + 1, (200, 16)),
        np.full((1, 16), ext), np.full((1, 16), -ext),
        np.where(np.arange(16) % 2, ext, -ext)[None],
        np.where(np.arange(16) < 8, ext, -ext)[None],
        rng.choice([-ext, ext, 0, 1, -1], (64, 16))]).astype(np.int64)
    got = fwht_lanes_model(dcs)
    want = dct.fwht4x4(torch.from_numpy(dcs.reshape(-1, 4, 4)).to(
        torch.int32)).reshape(-1, 16).numpy()
    jwant = np.asarray(dct_jax.fwht4x4(jnp.asarray(
        dcs.reshape(-1, 4, 4).astype(np.int32)))).reshape(-1, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jwant)
