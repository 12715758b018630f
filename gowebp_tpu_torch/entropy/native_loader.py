"""Build + load the native C++ host library (ctypes).

Compiles gowebp_tpu_torch/entropy/native/*.cpp with g++ into one shared
library under gowebp_tpu_torch/_build/ on first use (cached by source
hash), for the build host's own instruction set (``-march=native``): the
interleaved symbol decoder (vp8_dec_batch.cpp) vectorises only where
AVX-512 is there.  The encoders' emission, the VP8L encoder's
transform analysis and parsers, the decoders and the host
reconstruction have no pure-Python fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..errors import WebPError

_NATIVE_DIR = Path(__file__).parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib = None


def _sources() -> list[Path]:
    return sorted(_NATIVE_DIR.glob("*.cpp"))


_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
          "-fno-exceptions", "-march=native", "-funroll-loops"]


def _build() -> Path:
    srcs = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs + sorted(_NATIVE_DIR.glob("*.h")):
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    _BUILD_DIR.mkdir(exist_ok=True)
    so_path = _BUILD_DIR / f"libwtpu_host_{tag}.so"
    if so_path.exists():
        return so_path
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp)] + [str(s) for s in srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise WebPError(
            "native host library build failed:\n"
            + e.stderr.decode(errors="replace")[-4000:]) from e
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise WebPError(f"native host library build failed: {e}") from e
    tmp.replace(so_path)
    return so_path


def get_lib():
    """The loaded CDLL; builds it on first use and raises if it cannot."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib) -> None:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    u64p = c.POINTER(c.c_uint64)
    i16p = c.POINTER(c.c_int16)

    lib.wtpu_vp8_token_stats.restype = c.c_int
    lib.wtpu_vp8_token_stats.argtypes = [
        i16p, i16p, i16p, u8p, c.c_int, c.c_int, c.POINTER(c.c_int64), u8p,
    ]
    lib.wtpu_vp8_token_emit_multi.restype = c.c_int
    lib.wtpu_vp8_token_emit_multi.argtypes = [
        i16p, i16p, i16p, u8p, c.c_int, c.c_int, u8p, c.c_int, u8p, c.c_int,
        c.POINTER(c.POINTER(c.c_uint8)), u64p, u64p,
    ]
    lib.wtpu_vp8_write_modes.restype = c.c_int
    lib.wtpu_vp8_write_modes.argtypes = [
        u8p, c.c_uint64, c.c_uint64, c.c_uint32, c.c_int,
        u8p, u8p, u8p, u8p, u8p, u8p,
        c.c_int, c.c_int,
        c.c_int, c.c_int, u8p,
        c.POINTER(c.POINTER(c.c_uint8)), u64p,
    ]
    lib.wtpu_free.restype = None
    lib.wtpu_free.argtypes = [c.c_void_p]
    lib.wtpu_rgba_to_yuv420.restype = None
    lib.wtpu_rgba_to_yuv420.argtypes = [
        u8p, c.c_int, c.c_int, u8p, u8p, u8p,
    ]

    i32p = c.POINTER(c.c_int32)
    u32p = c.POINTER(c.c_uint32)
    lib.wtpu_vp8_parse_probs.restype = c.c_int
    lib.wtpu_vp8_parse_probs.argtypes = [
        u8p, c.c_uint64, u64p,                # data, size, state[4]
        u8p, u8p,                             # update_probs, probs (inout)
    ]
    lib.wtpu_vp8_decode_symbols.restype = c.c_int
    lib.wtpu_vp8_decode_symbols.argtypes = [
        u8p, c.c_uint64, c.c_uint64, c.c_uint32, c.c_uint32, c.c_uint32,
        u8p, u64p, c.c_int,                   # parts, offsets, num_parts
        c.c_int, c.c_int,                     # mb_w, mb_h
        c.c_int, u8p,                         # update_map, segment_probs
        c.c_int, c.c_int,                     # use_skip, skip_p
        u8p, i32p,                            # coeff_probs, quants
        i16p, u8p,                            # coeffs_out, modes_out
    ]
    lib.wtpu_vp8_batch_is_vectorized.restype = c.c_int
    lib.wtpu_vp8_batch_is_vectorized.argtypes = []
    lib.wtpu_vp8_decode_symbols_batch.restype = c.c_int
    lib.wtpu_vp8_decode_symbols_batch.argtypes = [
        c.c_int,                              # n_img
        u8p, u64p,                            # p0_all, p0_off
        u64p, u32p, u32p, u32p,               # p0 pos/value/range/bitcount
        u8p, u64p,                            # parts_all, parts_off
        u64p, i32p,                           # part_bounds, part_bounds_off
        i32p,                                 # num_parts
        i32p, i32p,                           # mb_dims, hdr_flags
        u8p, u8p, i32p,                       # seg_probs, coeff_probs, quants
        i16p, u64p,                           # coeffs_all, coeffs_off
        u8p, u64p,                            # modes_all, modes_off
        i32p,                                 # rc_out
    ]

    # host reconstruction (recon_backend="host")
    lib.wtpu_vp8_recon_frame_arrays.restype = None
    lib.wtpu_vp8_recon_frame_arrays.argtypes = [
        i16p, u8p,                            # coeffs, modes
        c.c_int, c.c_int, c.c_int, i32p,      # mb_w, mb_h, filter_type, finfo
        u8p, u8p, u8p,                        # y, u, v out
    ]
    lib.wtpu_yuv_to_rgba_fancy.restype = None
    lib.wtpu_yuv_to_rgba_fancy.argtypes = [
        u8p, u8p, u8p, c.c_int, c.c_int, c.c_int, c.c_int, u8p,
    ]

    # the batch decode's sparse coefficient pack (ops/coeff_pack.py)
    i8p = c.POINTER(c.c_int8)
    i64p = c.POINTER(c.c_int64)
    vpp = c.POINTER(c.c_void_p)
    lib.wtpu_vp8_pack_scan.restype = None
    lib.wtpu_vp8_pack_scan.argtypes = [
        vpp, u8p, u8p, i32p,                  # coeffs[B], seg, is_i4, qmat
        c.c_int, c.c_int,                     # B, N
        i8p, i16p,                            # head, dc16
        i32p, i8p, i32p, i64p,                # t4_idx, t4_val, exc_idx, counts
    ]
    lib.wtpu_vp8_pack_emit.restype = c.c_int64
    lib.wtpu_vp8_pack_emit.argtypes = [
        vpp, c.c_int, c.c_int, c.c_int,       # coeffs[B], B, N, K
        i8p, i32p, i8p, c.c_int64,            # head, t4_idx, t4_val, rows
        i32p, c.c_int64, i16p,                # exc_idx, rows, exc_val
        i8p, i32p, i8p, c.c_int64,            # lv8, tail_idx, tail_val, cap
    ]

    # VP8L decode and the ALPH unfilter
    lib.wtpu_vp8l_read_groups.restype = c.c_int
    lib.wtpu_vp8l_read_groups.argtypes = [
        u8p, c.c_uint64, c.c_uint64,          # data, size, bit_pos
        c.c_int, i32p, i32p, u64p,            # groups, alphabets, out, pos
    ]
    lib.wtpu_vp8l_decode_pixels.restype = c.c_int
    lib.wtpu_vp8l_decode_pixels.argtypes = [
        u8p, c.c_uint64, c.c_uint64,          # data, size, bit_pos
        c.c_int, c.c_int, c.c_int,            # width, height, num_groups
        i32p, i32p, i32p,                     # alphabet_sizes, lengths, offsets
        i32p, c.c_int, c.c_int,               # huffman_image, bits, meta_w
        c.c_int,                              # cache_bits
        u32p, u64p,                           # out, bit_pos_out
    ]
    lib.wtpu_vp8l_add_green.restype = None
    lib.wtpu_vp8l_add_green.argtypes = [u32p, c.c_int64]
    lib.wtpu_vp8l_color_inverse.restype = None
    lib.wtpu_vp8l_color_inverse.argtypes = [
        u32p, c.c_int, c.c_int, u32p, c.c_int, c.c_int,
    ]
    lib.wtpu_vp8l_predictor_inverse.restype = None
    lib.wtpu_vp8l_predictor_inverse.argtypes = [
        u32p, c.c_int, c.c_int, u32p, c.c_int, c.c_int,
    ]
    lib.wtpu_argb_to_rgba.restype = None
    lib.wtpu_argb_to_rgba.argtypes = [u32p, u8p, c.c_int64]
    lib.wtpu_alpha_unfilter.restype = None
    lib.wtpu_alpha_unfilter.argtypes = [u8p, c.c_int, c.c_int, c.c_int]

    # VP8L encode: the transforms' analysis (the host predictor chooser,
    # the forward predictor residual, the cross-colour fit), backward
    # references, the colour cache and the symbol emission
    lib.wtpu_vp8l_choose_predictors.restype = None
    lib.wtpu_vp8l_choose_predictors.argtypes = [
        u32p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.wtpu_vp8l_cross_color_fit.restype = None
    lib.wtpu_vp8l_cross_color_fit.argtypes = [
        u32p, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int8), c.POINTER(c.c_double),
    ]
    lib.wtpu_vp8l_predictor_residual.restype = None
    lib.wtpu_vp8l_predictor_residual.argtypes = [
        u32p, c.c_int, c.c_int, c.c_int, u32p, c.c_int, u32p,
    ]
    f32p = c.POINTER(c.c_float)
    lib.wtpu_vp8l_hashchain_refs.restype = c.c_int64
    lib.wtpu_vp8l_hashchain_refs.argtypes = [
        u32p, c.c_int64, c.c_int, c.c_int, c.c_int,   # flat, n, width, depth, cache
        u8p, u32p, i32p, i32p,                        # ops, argbs, lens, dists
    ]
    lib.wtpu_vp8l_greedy_refs.restype = c.c_int64
    lib.wtpu_vp8l_greedy_refs.argtypes = [
        u32p, c.c_int64, c.c_int, c.c_int, c.c_int,   # flat, n, width, min, max
        u8p, u32p, i32p, i32p,
    ]
    lib.wtpu_vp8l_optimal_refs.restype = c.c_int64
    lib.wtpu_vp8l_optimal_refs.argtypes = [
        u32p, c.c_int64, c.c_int, c.c_int, c.c_int,   # flat, n, width, depth, cache
        f32p, f32p, f32p, f32p, f32p,                 # symbol costs of the 5 trees
        i32p, c.c_int,                                # dist lut, its size
        u8p, u32p, i32p, i32p,
    ]
    lib.wtpu_vp8l_cache_score.restype = None
    lib.wtpu_vp8l_cache_score.argtypes = [
        u8p, u32p, i32p, c.c_int64, u32p, c.c_int, c.POINTER(c.c_double),
    ]
    lib.wtpu_vp8l_cache_apply.restype = None
    lib.wtpu_vp8l_cache_apply.argtypes = [
        u8p, u32p, i32p, c.c_int64, u32p, c.c_int,
    ]
    lib.wtpu_vp8l_emit.restype = c.c_int
    lib.wtpu_vp8l_emit.argtypes = [
        u8p, u32p, i32p, i32p, c.c_int64, c.c_int,    # refs, n_ops, width
        c.POINTER(c.c_uint16), u8p, i32p,             # code bits, lengths, offsets
        i32p, c.c_int,                                # dist lut, its size
        c.c_uint32, c.c_int,                          # writer acc, used bits
        c.POINTER(c.POINTER(c.c_uint8)), u64p,        # out bytes, their count
        u32p, i32p,                                   # writer acc, used after
    ]
    lib.wtpu_vp8l_emit_grouped.restype = c.c_int
    lib.wtpu_vp8l_emit_grouped.argtypes = [
        u8p, u32p, i32p, i32p, i32p, c.c_int64, c.c_int,  # refs, groups, n, w
        c.POINTER(c.c_uint16), u8p, i32p, c.c_int,        # codes, offsets, groups
        i32p, c.c_int,
        c.c_uint32, c.c_int,
        c.POINTER(c.POINTER(c.c_uint8)), u64p,
        u32p, i32p,
    ]


__all__ = ["get_lib"]
