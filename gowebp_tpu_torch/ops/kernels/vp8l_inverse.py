"""The VP8L predictor inverse: the Hopper kernel, its binding and its plain
version.

``predictor_inverse(residuals, mode_img, bits, add_green=False)`` turns a
batch of predictor residual images that share one mode image back into
pixels: every pixel is its residual plus the prediction of the tile's
predictor from its already decoded neighbours, with the decoder's edge
rules (row 0 predicts from the left, starting from black; column 0 from
above; the last column's top-right is the current row's pixel 0).
``add_green`` then applies the add-green inverse to every pixel.  On a
CUDA tensor it launches ``vp8l_inverse.cu`` (replacing the XLA functions
gowebp_tpu/ops/lossless_jax.py:363 ``predictor_inverse`` and, with the
epilogue, :39 ``add_green_inverse``): a warp a group of 32 rows, row
groups pipelined across SMs through edge rows in a zeroed scratch buffer
that the wrapper allocates with the launch's ticket; on a CPU tensor it
runs ``predictor_inverse_plain``, the same recurrence as torch ops, one
anti-diagonal (t = x + 2y) of the whole batch a step.

Layout:
  residuals  (B, h, w) int32, the ARGB words' bits
  mode_img   (th, tw) int32, th = ceil(h / 2^bits), tw = ceil(w / 2^bits);
             the predictor of a tile is bits 8-15 of its word (a mode past
             13 predicts 0, as the reference's select does)
  out        (B, h, w) int32 ARGB bits
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_tensor, stream_handle

I32, I64 = torch.int32, torch.int64
BLACK = 0xFF000000


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vp8l_inverse_launch.restype = ctypes.c_int
    lib.vp8l_inverse_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.vp8l_inverse_scratch_words.restype = ctypes.c_longlong
    lib.vp8l_inverse_scratch_words.argtypes = [i, i, i]


LIBRARY = CudaLibrary("vp8l_inverse.cu", _configure)


def to_bits(words):
    """int64 words in 0..2^32-1 → int32 tensors holding their bits."""
    return (words - ((words >> 31) & 1) * (1 << 32)).to(I32)


def add_pixels(x, p):
    """Byte-wise (x + p) mod 256 of int64 words."""
    lo = ((x & 0x00FF00FF) + (p & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) & 0x00FF00FF) + ((p >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return lo | (hi << 8)


def add_green_words(v):
    """The add-green inverse of int64 words: green added to red and blue."""
    g = (v >> 8) & 0xFF
    r = (((v >> 16) & 0xFF) + g) & 0xFF
    b = ((v & 0xFF) + g) & 0xFF
    return (v & 0xFF00FF00) | (r << 16) | b


def _tile_modes(mode_img, h: int, w: int, bits: int):
    """(h, w) int64 predictor of every pixel from the (th, tw) mode image."""
    modes = (mode_img.to(I64) >> 8) & 0xFF
    ys = torch.arange(h, device=modes.device) >> bits
    xs = torch.arange(w, device=modes.device) >> bits
    return modes[ys][:, xs]


def predictor_inverse_plain(residuals, mode_img, bits: int,
                            add_green: bool = False):
    """Plain torch version of the kernel (any device): one anti-diagonal
    t = x + 2y of every image a step, all 14 predictors computed and each
    pixel's selected."""
    from ..lossless import to_words
    from ..lossless import apply_predictor

    B, h, w = residuals.shape
    dev = residuals.device
    res = to_words(residuals)
    modes = _tile_modes(mode_img, h, w, bits)
    out = torch.zeros((B, h, w), dtype=I64, device=dev)
    for t in range(w + 2 * (h - 1)):
        lo, hi = max(0, (t - w + 2) // 2), min(h - 1, t // 2)
        ys = torch.arange(lo, hi + 1, device=dev)
        xs = t - 2 * ys
        yu, xl = (ys - 1).clamp_min(0), (xs - 1).clamp_min(0)
        xr = (xs + 1).clamp_max(w - 1)
        L = out[:, ys, xl]
        T = out[:, yu, xs]
        TL = out[:, yu, xl]
        # the last column's top-right is the current row's pixel 0
        TR = torch.where(xs + 1 < w, out[:, yu, xr], out[:, ys, 0])
        m = modes[ys, xs]
        pred = torch.zeros_like(L)
        for k in range(14):
            pred = torch.where(m == k, apply_predictor(k, L, T, TL, TR), pred)
        pred = torch.where(xs == 0, T, pred)                  # column 0
        row0 = torch.where(xs == 0, torch.full_like(L, BLACK), L)
        pred = torch.where(ys == 0, row0, pred)               # row 0
        out[:, ys, xs] = add_pixels(res[:, ys, xs], pred)
    if add_green:
        out = add_green_words(out)
    return to_bits(out)


def _check(residuals, mode_img, bits: int):
    if residuals.dim() != 3 or 0 in residuals.shape:
        raise ValueError(f"predictor_inverse: residuals must be (B, h, w), "
                         f"got {tuple(residuals.shape)}")
    if not 0 <= bits <= 16:
        raise ValueError(f"predictor_inverse: bits {bits} out of range")
    _, h, w = residuals.shape
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    if tuple(mode_img.shape) != (th, tw):
        raise ValueError(f"predictor_inverse: mode_img must be ({th}, {tw}), "
                         f"got {tuple(mode_img.shape)}")


def predictor_inverse(residuals, mode_img, bits: int,
                      add_green: bool = False):
    """Kernel on a CUDA tensor, plain version on a CPU tensor → (B, h, w)
    int32 pixels.  ``predictor_inverse.launches`` counts kernel launches
    (one per call on CUDA)."""
    _check(residuals, mode_img, bits)
    dev = residuals.device
    if dev.type == "cpu":
        return predictor_inverse_plain(residuals, mode_img, bits, add_green)
    if dev.type != "cuda":
        raise ValueError(f"predictor_inverse: unsupported device {dev}")
    out = launch(residuals, mode_img, bits, add_green)
    predictor_inverse.launches += 1
    return out


def launch(residuals, mode_img, bits: int, add_green: bool = False,
           warps: int = 0):
    """One launch of the kernel on CUDA tensors, ``warps`` warps a CTA (0:
    the kernel's default); counts nothing."""
    B, h, w = residuals.shape
    dev = residuals.device
    check_tensor("residuals", residuals, I32, (B, h, w), dev)
    check_tensor("mode_img", mode_img, I32, tuple(mode_img.shape), dev)
    lib = LIBRARY.load()
    out = torch.empty((B, h, w), dtype=I32, device=dev)
    scratch = torch.zeros(lib.vp8l_inverse_scratch_words(B, h, w),
                          dtype=I64, device=dev)
    err = lib.vp8l_inverse_launch(
        residuals.data_ptr(), mode_img.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, h, w, int(bits), int(bool(add_green)),
        int(warps), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"predictor_inverse kernel launch failed: CUDA error {err}")
    return out


predictor_inverse.launches = 0

__all__ = ["LIBRARY", "add_green_words", "add_pixels", "predictor_inverse",
           "predictor_inverse_plain", "to_bits"]
