"""VP8 (WebP lossy) encoder: the host half of the batch and single-image
encodes, and the single-image frame encoders.

The host pieces around the device stage: RGB→YUV420 (native; dithered
and sharp forms in numpy), quality and quantizer mapping, the i4 RD
penalties, segmentation, probability finalization, the frame headers,
and emission through the native C++ tokenizer.  The dense per-macroblock
coding runs on the device (ops/encode_wavefront.py, ops/encode_plane.py):
``encode_vp8_frame`` is the host encoder's decisions (``plane_backend``
"numpy": its trellis second pass at method 6, rate control, filter-level
trials, statistics) with the exact engine as its dense phase;
``encode_vp8_frame_device`` the other two backends' ("jax": the exact
engine with the plain quantizer mapping, "jax-openloop": the open-loop
plane engine).  Their own decodes (filter-level trials, target PSNR,
``stats.psnr``) run on the device too (decode.py ``decode_vp8_yuv``).

The native library is required: every entry here that needs it raises
when it cannot be built (entropy/native_loader.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ...config import EncoderConfig
from ...constants import CHUNK_ALPHA, CHUNK_VP8
from ...container.riff import Chunk, assemble, assemble_simple, build_vp8x
from ...entropy.bool_coder import BoolEncoder
from ...entropy.native_loader import get_lib
from ...errors import EncodeError
from .decoder import _RANDOM_TABLE, _centre
from .tables import AC_QUANT, COEFF_PROBAS, COEFF_UPDATE_PROBAS, DC_QUANT

# i4 rate-distortion weight: lambda = I4_LAMBDA_MULT * q_ac^2.
I4_LAMBDA_MULT = 4
# Trellis rate-distortion weight: lambda = (NUM * q_ac^2) >> SHIFT.
TRELLIS_LAMBDA_NUM = 1
TRELLIS_LAMBDA_SHIFT = 10

# The device encoder's split-limb (lambda*rate)>>16 is exact only for
# lambda < 2^19, so every computed penalty is clamped to this ceiling.
# Beyond it i4 effectively never wins, so the clamp is
# behaviour-preserving.
I4_PENALTY_MAX = (1 << 19) - 1

# Reference gate for UV DC error diffusion (encoder_iterator.go:57).
ERROR_DIFFUSION_QUALITY = 98


# ---------------------------------------------------------------------------
# Color conversion
# ---------------------------------------------------------------------------


def rgb_to_yuv420(rgba: np.ndarray):
    """(H, W, 3|4) uint8 → Y (H,W), U,V ((H+1)//2, (W+1)//2), int32 arrays.

    Matches libwebp's ImportYUVAFromRGBA: per-pixel Y, 2x2-accumulated
    chroma with the same fixed-point rounding (native kernel).
    """
    h, w = rgba.shape[:2]
    lib = get_lib()
    if rgba.shape[2] == 3:
        rgba4 = np.empty((h, w, 4), np.uint8)
        rgba4[..., :3] = rgba
        rgba4[..., 3] = 255
    else:
        rgba4 = np.ascontiguousarray(rgba, np.uint8)
    yo = np.empty((h, w), np.uint8)
    uo = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    vo = np.empty_like(uo)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.wtpu_rgba_to_yuv420(
        rgba4.ctypes.data_as(u8p), h, w,
        yo.ctypes.data_as(u8p), uo.ctypes.data_as(u8p),
        vo.ctypes.data_as(u8p),
    )
    return yo.astype(np.int32), uo.astype(np.int32), vo.astype(np.int32)


YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)


def _rgb_to_y(r, g, b, rounding=YUV_HALF):
    return (16839 * r + 33059 * g + 6420 * b + rounding
            + (16 << YUV_FIX)) >> YUV_FIX


def _clip_uv(uv, rounding):
    uv = (uv + rounding + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    return np.clip(uv, 0, 255)


def _rgb_to_u(r, g, b, rounding=YUV_HALF << 2):
    return _clip_uv(-9719 * r - 19081 * g + 28800 * b, rounding)


def _rgb_to_v(r, g, b, rounding=YUV_HALF << 2):
    return _clip_uv(28800 * r - 24116 * g - 4684 * b, rounding)


def _vp8_random_stream(n: int, num_bits: int, amp: int) -> np.ndarray:
    """n centred dither draws from a fresh VP8Random table, as the
    reference encoder's block-vectorized stream draws them.

    That stream takes 55 draws a block: 24 from the block's starting
    table, then 31 from a second vector step that reads entries 24..30
    as they stood before that step updated them.  From draw 48 on it
    therefore parts from ``VP8Random.raw`` (which reads the updated
    entries); the reference's bytes need the reference's draws.  The
    bits2 mapping is the decoder's ``_centre``.
    """
    tab = np.array(_RANDOM_TABLE, np.int64)
    out = np.empty(n, np.int64)
    for pos in range(0, n, 55):
        k = min(55, n - pos)
        first = min(k, 24)
        tab[:first] = (tab[:first] - tab[31:31 + first]) & 0x7FFFFFFF
        if k > 24:
            tab[24:k] = (tab[24:k] - tab[:k - 24]) & 0x7FFFFFFF
        out[pos:pos + k] = tab[:k]
    return _centre(out, num_bits, amp)


def _sum2x2(p: np.ndarray) -> np.ndarray:
    """Sums of the 2x2 cells of an edge-padded-to-even plane."""
    h, w = p.shape
    p = np.pad(p, ((0, h & 1), (0, w & 1)), mode="edge")
    return p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]


def rgb_to_yuv420_dithered(rgba: np.ndarray, dithering: float):
    """RGB(A) → YUV420 with VP8Random-dithered fixed-point rounding (the
    ``preprocessing & 2`` path): every Y, U and V sample's rounding term
    is drawn from the VP8Random stream instead of the constant half.
    Draw order: all Y rounding values (row-major), then per chroma pixel
    U, V."""
    h, w = rgba.shape[:2]
    amp = int(dithering * 256.0 + 0.5)
    r, g, b = (rgba[..., c].astype(np.int64) for c in range(3))
    uv_h, uv_w = (h + 1) // 2, (w + 1) // 2
    stream_y = _vp8_random_stream(h * w, YUV_FIX, amp)
    stream_uv = _vp8_random_stream(2 * uv_h * uv_w, YUV_FIX + 2, amp)
    y = _rgb_to_y(r, g, b, rounding=stream_y.reshape(h, w))
    rs, gs, bs = _sum2x2(r), _sum2x2(g), _sum2x2(b)
    u = _rgb_to_u(rs, gs, bs, rounding=stream_uv[0::2].reshape(uv_h, uv_w))
    v = _rgb_to_v(rs, gs, bs, rounding=stream_uv[1::2].reshape(uv_h, uv_w))
    return (y.astype(np.int32), u.astype(np.int32), v.astype(np.int32))


def rgb_to_yuv420_sharp(rgba: np.ndarray):
    """Sharp (iterative) RGB→YUV420: refine Y, U, V so that the fancy-
    upsampled reconstruction matches the source at chroma edges, four
    steps of a damped fixed-point descent on the planes (the use_sharp_yuv
    path).  The
    upsampling and YUV→RGB are the decode's torch functions, on the
    host."""
    from ...ops.yuv import fancy_upsample, yuv_to_rgb

    h, w = rgba.shape[:2]
    r, g, b = (rgba[..., c].astype(np.int64) for c in range(3))
    y, u, v = (p.astype(np.int64) for p in rgb_to_yuv420(rgba))

    def up(p):
        return fancy_upsample(torch.from_numpy(np.clip(p, 0, 255)), h, w)

    for _ in range(4):
        rec = yuv_to_rgb(torch.from_numpy(np.clip(y, 0, 255)), up(u),
                         up(v)).numpy().astype(np.int64)
        er = r - rec[..., 0]
        eg = g - rec[..., 1]
        eb = b - rec[..., 2]
        # Project the RGB error onto Y and (downsampled) U/V axes.
        dy = (16839 * er + 33059 * eg + 6420 * eb) >> 16
        du = _sum2x2((-9719 * er - 19081 * eg + 28800 * eb) >> 16) // 4
        dv = _sum2x2((28800 * er - 24116 * eg - 4684 * eb) >> 16) // 4
        y = np.clip(y + (dy * 3) // 4, 0, 255)
        u = np.clip(u + (du * 3) // 4, 0, 255)
        v = np.clip(v + (dv * 3) // 4, 0, 255)
    return y, u, v


def _smooth_segment_map(seg_map: np.ndarray, mb_w: int, mb_h: int
                        ) -> np.ndarray:
    """3x3 majority filter over interior MBs (libwebp's SmoothSegmentMap,
    the ``preprocessing & 1`` tool)."""
    m = np.asarray(seg_map).reshape(mb_h, mb_w)
    if mb_h < 3 or mb_w < 3:
        return m.reshape(-1)
    out = m.copy()
    counts = np.zeros((4, mb_h - 2, mb_w - 2), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = m[1 + dy: mb_h - 1 + dy, 1 + dx: mb_w - 1 + dx]
            for s in range(4):
                counts[s] += nb == s
    maj = counts.argmax(axis=0)
    hit = counts.max(axis=0) >= 5
    inner = out[1:-1, 1:-1]
    out[1:-1, 1:-1] = np.where(hit, maj, inner)
    return out.reshape(-1)


def _pad_to_mb(plane: np.ndarray, mb_size: int) -> np.ndarray:
    h, w = plane.shape
    H = (h + mb_size - 1) // mb_size * mb_size
    W = (w + mb_size - 1) // mb_size * mb_size
    return np.pad(plane, ((0, H - h), (0, W - w)), mode="edge")


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def quality_to_q(quality: float, *, emulate_jpeg_size: bool = False,
                 jpeg_alpha: float = 0.5) -> int:
    """Map quality 0..100 → quantizer index 0..127 (libwebp's power law).

    emulate_jpeg_size swaps in the libjpeg6b-matched compression curve
    (libwebp's QualityToJPEGCompression); jpeg_alpha is the image's
    normalized quantization susceptibility.
    """
    c = quality / 100.0
    if emulate_jpeg_size:
        amin, amax, exp_min, exp_max = 0.30, 0.85, 0.4, 0.9
        slope = (exp_min - exp_max) / (amax - amin)
        a = jpeg_alpha
        expn = (exp_min if a > amax else
                exp_max if a < amin else exp_max + slope * (a - amin))
        v = c ** expn
    else:
        linear_c = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
        v = linear_c ** (1.0 / 3.0)
    return int(127.0 * (1.0 - v) + 0.5)


def _i4_penalty_scale(partition_limit: int) -> float | None:
    """partition_limit 0..100 → i4 score-penalty multiplier (None = i4 off).

    The reference shrinks the i4 header-bit budget quadratically with
    (100 - partition_limit) (MapConfigToTools, webp_encoder.go:82-98);
    with a score-based search the same pressure is an inverse-quadratic
    penalty scale on choosing i4 over i16.
    """
    limit = 100 - partition_limit
    if limit <= 0:
        return None
    return (100.0 * 100.0) / (limit * limit)


def _i4_config_seg(qsteps_rows, method: int, partition_limit: int):
    """(try_i4, (4,) int32 per-segment penalties).

    The RD lambda follows each segment's own quantizer (the reference
    derives lambda per segment in SetupMatrices, quant_enc.c.go:125).
    qsteps_rows: (4, 6) rows of quant steps (column 1 = y1_ac).
    """
    scale = _i4_penalty_scale(partition_limit)
    pens = np.empty(4, np.int32)
    for s in range(4):
        q_ac = int(qsteps_rows[s][1])
        pens[s] = min(int(I4_LAMBDA_MULT * q_ac * q_ac
                          * (scale if scale is not None else 1.0)),
                      I4_PENALTY_MAX)
    return (method >= 4 and scale is not None), pens


@dataclass
class QuantPair:
    q: int      # quantizer step
    iq: int     # (1<<17)/q
    bias: int

    @classmethod
    def make(cls, q: int, bias8: int) -> "QuantPair":
        return cls(q=q, iq=(1 << 17) // q, bias=bias8 << 9)


@dataclass
class SegmentQuant:
    y1_dc: QuantPair
    y1_ac: QuantPair
    y2_dc: QuantPair
    y2_ac: QuantPair
    uv_dc: QuantPair
    uv_ac: QuantPair


def make_quants(base_q: int) -> SegmentQuant:
    """Derive the per-type quant steps exactly as the decoder will."""
    q = base_q
    y1_dc = int(DC_QUANT[min(q, 127)])
    y1_ac = int(AC_QUANT[min(q, 127)])
    y2_dc = int(DC_QUANT[min(q, 127)]) * 2
    y2_ac = max(8, (int(AC_QUANT[min(q, 127)]) * 101581) >> 16)
    uv_dc = int(DC_QUANT[min(q, 117)])
    uv_ac = int(AC_QUANT[min(q, 127)])
    return SegmentQuant(
        y1_dc=QuantPair.make(y1_dc, 96),
        y1_ac=QuantPair.make(y1_ac, 110),
        y2_dc=QuantPair.make(y2_dc, 96),
        y2_ac=QuantPair.make(y2_ac, 96),
        uv_dc=QuantPair.make(uv_dc, 110),
        uv_ac=QuantPair.make(uv_ac, 110),
    )


# ---------------------------------------------------------------------------
# Probabilities + headers
# ---------------------------------------------------------------------------


def finalize_probas(stats: np.ndarray):
    """Choose updated probabilities where the saving beats the header cost.

    Fully vectorized over the (4,8,3,11) probability tree.
    """
    n0 = stats[..., 0].astype(np.float64)
    n1 = stats[..., 1].astype(np.float64)
    total = n0 + n1
    old = COEFF_PROBAS.astype(np.int64)
    new = np.clip((n0 * 255 / np.maximum(total, 1)).astype(np.int64), 1, 255)

    def cost(prob):
        p = prob / 256.0
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_ln2 = 1.4426950408889634
            c = (-n0 * np.log(p + 1e-9)
                 - n1 * np.log(1.0 - p + 1e-9)) * inv_ln2
        return c

    old_cost = cost(old)
    new_cost = cost(new) + 8.0
    updates = (total > 0) & (new != old) & (old_cost - new_cost > 8.0)
    probs = np.where(updates, new, old).astype(np.uint8)
    return probs, updates


def filter_level_from_q(base_q: int, filter_strength: int, sharpness: int) -> int:
    """Loop-filter level heuristic (libwebp-style strength mapping)."""
    if filter_strength == 0:
        return 0
    level = base_q * filter_strength // 100
    return max(0, min(63, level >> 1))


_COST_TABLE_CACHE = None


def _default_cost_tables():
    """Token cost tables under the default coefficient probabilities."""
    global _COST_TABLE_CACHE
    if _COST_TABLE_CACHE is None:
        from .cost import trellis_cost_tables

        tp0, tp1, tval = trellis_cost_tables(COEFF_PROBAS)
        _COST_TABLE_CACHE = (
            np.ascontiguousarray(tp0),
            np.ascontiguousarray(tp1),
            np.ascontiguousarray(tval),
        )
    return _COST_TABLE_CACHE


def emit_frame_arrays(y2, yl, uvl, is_i4, ymodes, uvmodes,
                      mb_w: int, mb_h: int, width: int, height: int,
                      base_q: int, config: EncoderConfig,
                      imodes=None, seg=None, stats=None,
                      filter_level=None) -> bytes:
    """Array-driven emission via the native tokenizer → VP8 payload.

    ``filter_level`` overrides the config's loop-filter level; ``stats``
    (an ``EncodeStats``) gets the frame's counts and sizes."""
    native = _native_tokenizer_arrays(y2, yl, uvl, is_i4, mb_w, mb_h)
    return _finish_frame_native(
        native, is_i4, ymodes, uvmodes, imodes,
        mb_w, mb_h, width, height, base_q, config, seg, stats, filter_level,
    )


def _finish_frame_native(native, is_i4, ymodes, uvmodes, imodes, mb_w, mb_h,
                         width, height, base_q, config, seg, stats=None,
                         filter_level=None):
    """All-native emission: headers (Python) + modes + tokens (C++)."""
    lib = get_lib()
    total = mb_w * mb_h
    skip_flags = np.ascontiguousarray(native["skip"], np.uint8)
    probs, updates = finalize_probas(native["stats"])
    n_skip = int(skip_flags.sum())
    use_skip = n_skip > 0
    skip_p = max(1, min(255, ((total - n_skip) * 255) // total)) if use_skip else 0

    num_parts = 1 << config.partitions
    p0 = BoolEncoder()
    _write_p0_headers(p0, base_q, config, probs, updates, use_skip, skip_p,
                      seg=seg, filter_level=filter_level)
    out_p = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64(0)
    prefix = bytes(p0._buf)

    def u8(a):
        return np.ascontiguousarray(np.asarray(a).reshape(-1), np.uint8)

    ym = u8(ymodes)
    um = u8(uvmodes)
    i4 = u8(is_i4)
    im = (u8(imodes) if imodes is not None else np.zeros(total * 16, np.uint8))
    seg_map = (u8(seg["map"]) if seg is not None else None)
    seg_probs = (np.array(seg["probs"], np.uint8) if seg is not None else None)

    def p8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if a is not None else None

    lib.wtpu_vp8_write_modes(
        (ctypes.c_uint8 * len(prefix)).from_buffer_copy(prefix) if prefix
        else None,
        len(prefix), p0.bottom, p0.range, p0.bit_count,
        p8(ym), p8(um), p8(i4), p8(im), p8(skip_flags), p8(seg_map),
        mb_w, mb_h, int(use_skip), skip_p, p8(seg_probs),
        ctypes.byref(out_p), ctypes.byref(out_n),
    )
    part0 = ctypes.string_at(out_p, out_n.value)
    lib.wtpu_free(out_p)
    parts = native["emit"](probs, use_skip, num_parts)
    if stats is not None:
        stats.block_count_skipped = n_skip
        n_i4 = int(i4.sum())
        stats.block_count_i4 = n_i4
        stats.block_count_i16 = total - n_i4
        stats.header_bytes = len(part0)
        stats.residual_bytes = sum(len(pp) for pp in parts)
        stats.quantizer = base_q
        stats.filter_level = filter_level if filter_level is not None else \
            filter_level_from_q(base_q, config.filter_strength,
                                config.filter_sharpness)
        stats.num_partitions = num_parts
        _fill_segment_stats(stats, seg, base_q, total, i4, skip_flags)
    return _frame_bytes(part0, parts, width, height)


def _fill_segment_stats(stats, seg, base_q, total, i4, skip_flags) -> None:
    """Per-segment arrays of WebPAuxStats: quantizer, block counts
    (i4/i16/skip) per segment."""
    if seg is not None:
        seg_flat = np.asarray(seg["map"]).reshape(-1)
        stats.segment_quant = [max(0, min(127, base_q + d))
                               for d in seg["deltas"]]
    else:
        seg_flat = np.zeros(total, np.uint8)
        stats.segment_quant = [base_q] * 4
    i4f = np.asarray(i4).reshape(-1).astype(bool)
    skf = np.asarray(skip_flags).reshape(-1).astype(bool)
    stats.segment_block_i4 = [0] * 4
    stats.segment_block_i16 = [0] * 4
    stats.segment_block_skipped = [0] * 4
    for s in range(4):
        m = seg_flat == s
        stats.segment_block_i4[s] = int((m & i4f).sum())
        stats.segment_block_i16[s] = int((m & ~i4f).sum())
        stats.segment_block_skipped[s] = int((m & skf).sum())


def _write_p0_headers(p0, base_q, config, probs, updates, use_skip, skip_p,
                      seg=None, filter_level=None):
    p0.put_flag(0)  # color space
    p0.put_flag(0)  # clamp type
    if seg is None:
        p0.put_flag(0)  # no segmentation
    else:
        p0.put_flag(1)  # use_segment
        p0.put_flag(1)  # update_map
        p0.put_flag(1)  # update data
        p0.put_flag(0)  # absolute_delta = 0 (deltas relative to base q)
        for s in range(4):
            d = seg["deltas"][s]
            if d:
                p0.put_flag(1)
                p0.put_signed_literal(d, 7)
            else:
                p0.put_flag(0)
        for s in range(4):  # filter strength deltas: none
            p0.put_flag(0)
        for pr in seg["probs"]:
            if pr != 255:
                p0.put_flag(1)
                p0.put_literal(pr, 8)
            else:
                p0.put_flag(0)
    if filter_level is None:
        filter_level = filter_level_from_q(
            base_q, config.filter_strength, config.filter_sharpness
        )
    p0.put_flag(0 if config.filter_type else 1)
    p0.put_literal(filter_level, 6)
    p0.put_literal(config.filter_sharpness, 3)
    p0.put_flag(0)  # no lf deltas
    p0.put_literal(config.partitions, 2)  # log2(token partitions)
    p0.put_literal(base_q, 7)
    for _ in range(5):
        p0.put_flag(0)
    p0.put_flag(1)  # refresh entropy probs
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if updates[t, b, c, p]:
                        p0.put_bit(1, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
                        p0.put_literal(int(probs[t, b, c, p]), 8)
                    else:
                        p0.put_bit(0, int(COEFF_UPDATE_PROBAS[t, b, c, p]))
    p0.put_flag(1 if use_skip else 0)
    if use_skip:
        p0.put_literal(skip_p, 8)


# The frame tag holds the first partition's length in 19 bits, and each
# token partition's length but the last is 3 bytes (RFC 6386 9.1, 9.5).
MAX_PARTITION0_SIZE = (1 << 19) - 1
MAX_PARTITION_SIZE = (1 << 24) - 1


def _frame_bytes(part0, parts, width, height):
    """The VP8 frame: tag, start code, dimensions, the first partition,
    the token partitions' sizes and the token partitions.  Raises
    EncodeError where a length does not fit its field, as libwebp does
    (VP8_ENC_ERROR_PARTITION0_OVERFLOW, VP8_ENC_ERROR_PARTITION_OVERFLOW);
    the JAX package writes the truncated length instead."""
    if len(part0) > MAX_PARTITION0_SIZE:
        raise EncodeError(
            f"partition #0 is too big to fit 512k ({len(part0)} bytes); "
            f"partition_limit=100 codes no i4 modes")
    if any(len(p) > MAX_PARTITION_SIZE for p in parts[:-1]):
        raise EncodeError("a token partition is bigger than 16M; a larger "
                          "`partitions` splits it")
    tag = (0) | (0 << 1) | (1 << 4) | (len(part0) << 5)
    sizes = b"".join(
        bytes((len(p) & 0xFF, (len(p) >> 8) & 0xFF, (len(p) >> 16) & 0xFF))
        for p in parts[:-1]
    )
    return bytes(
        (
            tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF,
            0x9D, 0x01, 0x2A,
            width & 0xFF, (width >> 8) & 0x3F,
            height & 0xFF, (height >> 8) & 0x3F,
        )
    ) + part0 + sizes + b"".join(parts)


def _native_tokenizer_arrays(y2, yl, uvl, is_i4, mb_w: int, mb_h: int):
    """Run the C++ token-statistics pass; returns stats, skip flags and
    an ``emit(probs, use_skip, num_parts)`` closure for the second pass."""
    lib = get_lib()
    total = mb_w * mb_h
    y2 = np.ascontiguousarray(np.asarray(y2).reshape(total, 16), np.int16)
    yl = np.ascontiguousarray(np.asarray(yl).reshape(total, 16, 16), np.int16)
    uvl = np.ascontiguousarray(np.asarray(uvl).reshape(total, 8, 16), np.int16)
    is_i4 = np.ascontiguousarray(np.asarray(is_i4).reshape(total), np.uint8)

    stats = np.zeros((4, 8, 3, 11, 2), np.int64)
    skip = np.zeros(total, np.uint8)

    def i16p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    def u8p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    lib.wtpu_vp8_token_stats(
        i16p(y2), i16p(yl), i16p(uvl), u8p(is_i4), mb_w, mb_h,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), u8p(skip),
    )

    def emit(probs, use_skip, num_parts=1):
        probs_c = np.ascontiguousarray(probs, np.uint8)
        out_p = ctypes.POINTER(ctypes.c_uint8)()
        total = ctypes.c_uint64(0)
        sizes = np.zeros(num_parts, np.uint64)
        lib.wtpu_vp8_token_emit_multi(
            i16p(y2), i16p(yl), i16p(uvl), u8p(is_i4), mb_w, mb_h,
            u8p(probs_c), int(use_skip), u8p(skip), num_parts,
            ctypes.byref(out_p),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.byref(total),
        )
        data = ctypes.string_at(out_p, total.value)
        lib.wtpu_free(out_p)
        parts = []
        off = 0
        for s in sizes:
            parts.append(data[off : off + int(s)])
            off += int(s)
        return parts

    return {"stats": stats, "skip": skip, "emit": emit}


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------


def analyze_segments(y, mb_w: int, mb_h: int, num_segments: int,
                     sns_strength: int, base_q: int = 64):
    """Per-MB activity → segment map + quantizer deltas.

    The reference's VP8EncAnalyze/AssignSegments (analysis_enc.c.go:139,
    431): 1-D clustering of a susceptibility metric, re-done with a
    vectorized activity measure and quantile split.
    """
    ya = np.asarray(y, np.int32)
    H, W = mb_h * 16, mb_w * 16
    lap = np.abs(
        4 * ya[1:-1, 1:-1] - ya[:-2, 1:-1] - ya[2:, 1:-1]
        - ya[1:-1, :-2] - ya[1:-1, 2:]
    )
    lap = np.pad(lap, 1)[:H, :W]
    act = lap.reshape(mb_h, 16, mb_w, 16).mean(axis=(1, 3)).reshape(-1)
    return segments_from_activity(act, num_segments, sns_strength, base_q)


def segments_from_activity(act, num_segments: int, sns_strength: int,
                           base_q: int):
    """Per-MB activity vector (float64) → (seg_map, deltas)."""
    num_segments = max(1, int(num_segments))
    # 1-D k-means on activity (reference AssignSegments' centroid fit):
    # segments follow the actual activity clusters instead of fixed
    # population quartiles, so mostly-flat images put most MBs in the
    # cheap segment.
    qs = np.quantile(act, [(2 * s + 1) / (2 * num_segments)
                           for s in range(num_segments)])
    centers = np.unique(qs).astype(np.float64)
    for _ in range(8):
        assign = np.abs(act[:, None] - centers[None, :]).argmin(axis=1)
        new = np.array([
            act[assign == k].mean() if (assign == k).any() else centers[k]
            for k in range(len(centers))
        ])
        if np.allclose(new, centers):
            break
        centers = new
    order = np.argsort(centers)
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(len(order))
    seg_map = rank_of[assign].astype(np.uint8)
    centers = centers[order]

    # Asymmetric quantizer spread (reference SetSegmentParams shape):
    # flat segments get a deep discount (cheap PSNR on smooth areas),
    # busy segments a coarser step (masked detail, expensive bits).
    n = len(centers)
    if n > 1:
        a_norm = (centers - centers[0]) / max(1e-9, centers[-1] - centers[0])
    else:
        a_norm = np.zeros(1)
    # Scale the spread by how heterogeneous the image actually is: a
    # uniformly-textured photo keeps a near-flat quantizer, a graphics
    # image with flat fills + hard edges gets a wide one.
    rel = float((centers[-1] - centers[0]) / (centers[-1] + 8.0))
    s = min(100, sns_strength) / 50.0
    amp_lo = 0.45 * s * rel
    amp_hi = 0.50 * s * rel
    raw = np.array([
        base_q * (amp_hi * a - amp_lo * (1.0 - a)) for a in a_norm
    ])
    # Rate-neutral centering: shift the spread so the MB-population-
    # weighted mean quantizer stays at base_q — segmentation should
    # redistribute bits, not add them.
    counts = np.bincount(seg_map, minlength=n)[:n].astype(np.float64)
    raw -= float((counts * raw).sum() / max(1.0, counts.sum()))
    deltas = [int(round(d)) for d in raw]
    # Low relative activity spread = the quantiles split measurement
    # noise, not maskable structure: collapse to a single segment.
    if rel < 0.25 or max(deltas) - min(deltas) <= 2:
        deltas = [0] * n
    deltas += [0] * (4 - n)
    return seg_map, deltas


def _segment_tree_probs(seg_map: np.ndarray):
    counts = np.bincount(seg_map, minlength=4)
    total = counts.sum()
    lo = counts[0] + counts[1]
    p0 = int(np.clip(lo * 255 // max(1, total), 1, 255))
    p1 = int(np.clip(counts[0] * 255 // max(1, lo), 1, 255)) if lo else 255
    hi = counts[2] + counts[3]
    p2 = int(np.clip(counts[2] * 255 // max(1, hi), 1, 255)) if hi else 255
    return [p0, p1, p2]


# ---------------------------------------------------------------------------
# Single-image frame encoders
# ---------------------------------------------------------------------------


def _segment_setup(y, mb_w, mb_h, config, base_q, smooth: bool):
    """The frame's segmentation: None (one segment) or its map, deltas,
    tree probabilities and per-segment quantizers."""
    if config.segments <= 1:
        return None
    seg_map, deltas = analyze_segments(
        y, mb_w, mb_h, config.segments, config.sns_strength, base_q)
    if smooth and config.preprocessing & 1:
        seg_map = _smooth_segment_map(seg_map, mb_w, mb_h)
    if len(set(deltas[: config.segments])) <= 1:
        return None
    return {
        "map": seg_map,
        "deltas": deltas,
        "probs": _segment_tree_probs(seg_map),
        "quants": [make_quants(max(0, min(127, base_q + d)))
                   for d in deltas],
    }


def _qrow(sq: SegmentQuant):
    return [sq.y1_dc.q, sq.y1_ac.q, sq.y2_dc.q, sq.y2_ac.q, sq.uv_dc.q,
            sq.uv_ac.q]


def _dense_wavefront(y, u, v, mb_w, mb_h, q, seg, method, partition_limit,
                     use_derr, device, tables=None, lambdas=None):
    """The exact engine over one frame on ``device`` (the full-search
    kernel; its trellis form with ``lambdas``): the levels and modes as
    numpy arrays, one row per MB.  ``tables``: the (p0, p1, val) cost
    tables of the search's rate model (default: the default
    probabilities')."""
    from ...ops.encode_wavefront import encode_wavefront_core

    quants = seg["quants"] if seg is not None else [q] * 4
    qsteps = np.array([_qrow(s) for s in quants], np.int32)
    seg_arr = (np.asarray(seg["map"], np.int32) if seg is not None
               else np.zeros(mb_w * mb_h, np.int32)).reshape(mb_h, mb_w)
    try_i4, pens = _i4_config_seg(qsteps, method, partition_limit)
    if tables is None:
        tables = _default_cost_tables()

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        return t.to(device)[None]

    out = encode_wavefront_core(
        dev(y, np.uint8), dev(u, np.uint8), dev(v, np.uint8), dev(seg_arr),
        dev(qsteps), tuple(dev(t, np.int32)[0] for t in tables),
        try_i4=try_i4, i4_penalty=dev(pens), use_derr=bool(use_derr),
        trellis=None if lambdas is None else dev(lambdas))
    n = mb_w * mb_h
    shapes = {"y2_levels": (n, 16), "y_levels": (n, 16, 16),
              "uv_levels": (n, 8, 16), "ymode": (n,), "uvmode": (n,),
              "is_i4": (n,), "imodes": (n, 16)}
    return {k: out[k][0].cpu().numpy().reshape(s) for k, s in shapes.items()}


def _emit_dense(d, mb_w, mb_h, width, height, base_q, config, seg,
                stats=None, filter_level=None):
    return emit_frame_arrays(
        d["y2_levels"], d["y_levels"], d["uv_levels"], d["is_i4"],
        d["ymode"], d["uvmode"], mb_w, mb_h, width, height, base_q, config,
        imodes=d["imodes"], seg=seg, stats=stats, filter_level=filter_level)


def _jpeg_alpha(y) -> float:
    """Normalized susceptibility of the image (mean laplacian activity →
    [0, 1]) for the emulate_jpeg_size curve."""
    ya = np.asarray(y, np.int32)
    lap = np.abs(
        4 * ya[1:-1, 1:-1] - ya[:-2, 1:-1] - ya[2:, 1:-1]
        - ya[1:-1, :-2] - ya[1:-1, 2:]
    ).mean() if min(y.shape) > 2 else 0.0
    return float(lap / (lap + 40.0))


def encode_vp8_frame(y, u, v, width, height, config: EncoderConfig,
                     base_q: int | None = None, stats=None, *,
                     device) -> bytes:
    """Y/U/V planes (already MB-padded) → VP8 frame payload, with the host
    encoder's decisions (``plane_backend`` "numpy"): segment smoothing,
    ``emulate_jpeg_size``, at method 6 a trellis pass and the
    filter-level trials of ``autofilter``, the last two only without
    ``low_memory`` (libwebp's use_tokens gate)."""
    mb_w = y.shape[1] // 16
    mb_h = y.shape[0] // 16
    if base_q is None:
        if config.emulate_jpeg_size:
            base_q = quality_to_q(config.quality, emulate_jpeg_size=True,
                                  jpeg_alpha=_jpeg_alpha(y))
        else:
            base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100, min(config.qmax * 127 // 100, base_q))
    return _encode_dense(
        y, u, v, mb_w, mb_h, width, height, base_q, config, smooth=True,
        trellis=config.method >= 6 and not config.low_memory,
        autofilter=config.autofilter and not config.low_memory,
        stats=stats, device=device)


def _encode_dense(y, u, v, mb_w, mb_h, width, height, base_q,
                  config: EncoderConfig, *, smooth: bool, trellis: bool,
                  autofilter: bool, device, stats=None) -> bytes:
    """One frame through the exact engine, on the backends' decisions:
    the segmentation (``smooth``: the ``preprocessing & 1`` majority
    filter), the dense phase on ``device``, with ``trellis`` a second,
    trellis pass, the emission, and with ``autofilter`` the filter-level
    trials and a re-emission at the best level."""
    from .cost import trellis_cost_tables

    q = make_quants(base_q)
    seg = _segment_setup(y, mb_w, mb_h, config, base_q, smooth=smooth)
    # UV DC error diffusion at quality <= 98 (libwebp's gate).
    use_derr = config.quality <= ERROR_DIFFUSION_QUALITY
    args = (y, u, v, mb_w, mb_h, q, seg, config.method,
            config.partition_limit, use_derr, device)
    dense = _dense_wavefront(*args)
    if trellis:
        # Second dense pass with trellis quantization, rate-modelled on
        # the first pass's adapted probabilities (default-proba costs are
        # far too pessimistic once two-pass adaptation kicks in).
        first = _native_tokenizer_arrays(
            dense["y2_levels"], dense["y_levels"], dense["uv_levels"],
            dense["is_i4"], mb_w, mb_h)
        probs1, _ = finalize_probas(first["stats"])
        quants = seg["quants"] if seg is not None else [q] * 4
        lambdas = np.array(
            [max(1, (TRELLIS_LAMBDA_NUM * s.y1_ac.q * s.y1_ac.q)
                 >> TRELLIS_LAMBDA_SHIFT) for s in quants], np.int32)
        dense = _dense_wavefront(*args, tables=trellis_cost_tables(probs1),
                                 lambdas=lambdas)
    out = _emit_dense(dense, mb_w, mb_h, width, height, base_q, config, seg,
                      stats=stats)
    if autofilter:
        best = _autofilter(out, y, width, height, base_q, config, device)
        out = _emit_dense(dense, mb_w, mb_h, width, height, base_q, config,
                          seg, stats=stats, filter_level=best)
    return out


def _autofilter(payload, y_src, width, height, base_q, config: EncoderConfig,
                device) -> int:
    """The loop-filter level that maximizes the decoded luma PSNR, among
    a few around the heuristic level (each trial a decode on
    ``device``)."""
    from ...decode import decode_vp8_yuv

    base = filter_level_from_q(base_q, config.filter_strength,
                               config.filter_sharpness)
    cands = sorted({0, base // 2, base, min(63, base + base // 2 + 1),
                    min(63, 2 * base + 1)})
    best_level, best_err = None, None
    ref = np.asarray(y_src, np.float64)
    for lvl in cands:
        dy, _, _ = decode_vp8_yuv(payload, filter_level_override=lvl,
                                  device=device)
        err = ((dy[: height, : width] - ref[: height, : width]) ** 2).sum()
        if best_err is None or err < best_err:
            best_err, best_level = err, lvl
    return best_level


def _rate_controlled_encode(y, u, v, w, h, config: EncoderConfig,
                            device) -> bytes:
    """Multi-pass quantizer search toward target_size / target_psnr:
    bisection over the quantizer index, one whole frame encode a trial
    (and for target_psnr its decode on ``device``)."""
    from ...decode import decode_vp8_yuv

    lo = config.qmin * 127 // 100
    hi = max(lo + 1, config.qmax * 127 // 100)
    passes = max(4, config.passes)
    best_under = None          # (size, payload): largest size <= target
    best_any = None            # (score, payload): closest overall

    for _ in range(passes):
        q = (lo + hi) // 2
        payload = encode_vp8_frame(y, u, v, w, h, config, base_q=q,
                                   device=device)
        if config.target_size > 0:
            size = len(payload)
            if size <= config.target_size:
                if best_under is None or size > best_under[0]:
                    best_under = (size, payload)
                hi = q          # try finer quantization (bigger file)
            else:
                lo = q + 1      # too big: quantize harder
            if best_any is None or abs(size - config.target_size) < best_any[0]:
                best_any = (abs(size - config.target_size), payload)
        else:
            dec = decode_vp8_yuv(payload, device=device)
            se = 0.0
            n = 0
            for d, srcp in zip(dec, (y, u, v)):
                ref = np.asarray(srcp[: d.shape[0], : d.shape[1]], np.float64)
                se += ((d - ref) ** 2).sum()
                n += d.size
            mse = max(se / n, 1e-9)
            m = 10.0 * np.log10(255.0**2 / mse)
            if m >= config.target_psnr:
                if best_under is None or len(payload) < best_under[0]:
                    best_under = (len(payload), payload)
                lo = q + 1      # quality met: try harder quantization
            else:
                hi = q
            if best_any is None or abs(m - config.target_psnr) < best_any[0]:
                best_any = (abs(m - config.target_psnr), payload)
        if lo >= hi:
            break
    if best_under is not None:
        return best_under[1]
    return best_any[1]


def encode_vp8_frame_device(y, u, v, width, height, config: EncoderConfig,
                            *, device) -> bytes:
    """The reference's device backends' decisions: ``plane_backend``
    "jax" (the exact engine with the plain quantizer mapping, no segment
    smoothing, no trellis, the filter-level trials whatever
    ``low_memory`` says) or "jax-openloop" (the open-loop plane kernels,
    one quantizer, i16 only).  No statistics beyond the caller's."""
    base_q = quality_to_q(config.quality)
    base_q = max(config.qmin * 127 // 100, min(config.qmax * 127 // 100, base_q))
    mb_w = y.shape[1] // 16
    mb_h = y.shape[0] // 16
    if config.plane_backend == "jax":
        return _encode_dense(y, u, v, mb_w, mb_h, width, height, base_q,
                             config, smooth=False, trellis=False,
                             autofilter=config.autofilter, device=device)

    from ...ops.encode_plane import encode_plane_core_v2

    q = make_quants(base_q)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(
            device)[None]

    out = encode_plane_core_v2(
        dev(y), dev(u), dev(v), **{k: getattr(q, k).q for k in (
            "y1_dc", "y1_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")})
    d = {k: out[k][0].cpu().numpy() for k in (
        "ymode", "uvmode", "y_levels", "y2_levels", "uv_levels")}
    return emit_frame_arrays(
        d["y2_levels"], d["y_levels"], d["uv_levels"],
        np.zeros(mb_h * mb_w, np.uint8), d["ymode"], d["uvmode"],
        mb_w, mb_h, width, height, base_q, config)


def encode_vp8_webp(rgba: np.ndarray, config: EncoderConfig, stats=None, *,
                    device) -> bytes:
    """(H, W, 3|4) uint8 → complete .webp bytes (lossy, + ALPH if needed)."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise EncodeError("expected (H, W, 3|4) array")
    h, w = rgba.shape[:2]
    has_alpha = rgba.shape[2] == 4 and bool((rgba[..., 3] != 255).any())

    if config.use_sharp_yuv or (config.preprocessing & 4):
        y, u, v = rgb_to_yuv420_sharp(rgba)
    elif config.preprocessing & 2:
        # Dither amplitude: max at q0, 0.5 at q100.
        x = config.quality / 100.0
        y, u, v = rgb_to_yuv420_dithered(rgba, 1.0 - 0.5 * x ** 4)
    else:
        y, u, v = rgb_to_yuv420(rgba)
    y = _pad_to_mb(y, 16)
    u = _pad_to_mb(u, 8)
    v = _pad_to_mb(v, 8)
    if config.plane_backend in ("jax", "jax-openloop"):
        payload = encode_vp8_frame_device(y, u, v, w, h, config,
                                          device=device)
    elif config.target_size > 0 or config.target_psnr > 0:
        payload = _rate_controlled_encode(y, u, v, w, h, config, device)
    else:
        payload = encode_vp8_frame(y, u, v, w, h, config, stats=stats,
                                   device=device)
    if stats is not None:
        from ...decode import decode_vp8_yuv
        from ...utils.metrics import psnr as _psnr

        dec = decode_vp8_yuv(payload, device=device)
        stats.psnr = {
            name: _psnr(d, np.asarray(p[: d.shape[0], : d.shape[1]]))
            for name, d, p in zip("yuv", dec, (y, u, v))}

    if not has_alpha:
        return assemble_simple(Chunk(CHUNK_VP8, payload))
    from .alpha import encode_alpha

    alpha_payload = encode_alpha(
        rgba[..., 3],
        method=config.alpha_compression,
        quality=config.alpha_quality,
        filtering_level=config.alpha_filtering,
    )
    if stats is not None:
        stats.alpha_data_size = len(alpha_payload)
    return assemble(
        [
            build_vp8x(w, h, has_alpha=True),
            Chunk(CHUNK_ALPHA, alpha_payload),
            Chunk(CHUNK_VP8, payload),
        ]
    )


__all__ = [
    "ERROR_DIFFUSION_QUALITY",
    "analyze_segments",
    "emit_frame_arrays",
    "encode_vp8_frame",
    "encode_vp8_frame_device",
    "encode_vp8_webp",
    "filter_level_from_q",
    "finalize_probas",
    "make_quants",
    "quality_to_q",
    "rgb_to_yuv420",
    "segments_from_activity",
]
