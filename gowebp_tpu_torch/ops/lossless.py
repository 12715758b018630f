"""The VP8L encoder's predictors and per-tile predictor chooser on torch
tensors, and the decode side's inverses: ``add_green_inverse`` and
``predictor_inverse`` (ops/kernels/vp8l_inverse.py: a kernel on a CUDA
tensor, its plain version on a CPU tensor).

``predictor_search_entropy`` picks, for each (1 << bits)-square tile of
an ARGB image, the one of the 14 VP8L predictors whose residuals code
cheapest: stage 1 scores each tile by the Shannon entropy of its four
per-channel residual-byte histograms plus a magnitude bias, then
``refine_iters`` rounds re-score every tile by its cross-entropy under
the global residual distribution of the current picks plus the mode
symbol's cost, stopping early at a fixed point.  On a CUDA tensor it
runs the kernel of ops/kernels/vp8l_predictor.cu (one launch for stage
1 and one a round); on a CPU tensor the plain version of
ops/kernels/vp8l_predictor.py, built from the functions here.

The scores are integers, so the kernel and the plain version sum the
same numbers in any order and pick the same modes: ``n log2 n``, the
bias, the refinement's ``-log2 p`` and the mode costs are float64 values
scaled by 2^SCALE_BITS and rounded (``stage1_table``, ``refine_table``,
built on the host).  The JAX package scores in float32 and the host
chooser (entropy/native/vp8l_dec.cpp) in float and double, so their
picks can differ from these on a near tie.

Pixels are ARGB words, (a<<24)|(r<<16)|(g<<8)|b: int32 tensors hold
their bits, and the arithmetic here widens them to int64 (0..2^32-1).
"""

from __future__ import annotations

import numpy as np
import torch

# (H, W) int32 ARGB bits → the (th, tw) int32 mode map: the kernel on a
# CUDA tensor, its plain version on a CPU tensor (the same modes).
from .kernels.vp8l_predictor import predictor_search_entropy
# (B, h, w) int32 residuals, (th, tw) int32 mode image → (B, h, w) int32
# pixels, optionally through the add-green inverse: the kernel on a CUDA
# tensor, its plain version on a CPU tensor.
from .kernels.vp8l_inverse import predictor_inverse

I64 = torch.int64
BLACK = 0xFF000000
NUM_MODES = 14
BINS = 1024                      # 4 channels x 256 byte values
MIN_BITS, MAX_BITS = 2, 5
# A tile holds at most 4^MAX_BITS pixels: the largest count of a bin.
MAX_COUNT = 1 << (2 * MAX_BITS)
# Fixed point of the scores: every real-valued term times 2^40, rounded.
# A tile's stage-1 terms (4 n log2 n, sum(h log2 h) <= 4 n log2 n and
# sum(h * bias) <= 0.04 * 128 * 4n, at n = 1024) stay below 2^17 before
# scaling, in any order of summing; a round's (4n counts times -log2 p <=
# log2((2^28 + 25.6) / 0.1) < 32 for a 16384 x 16384 image, plus a mode
# cost below 32) below 2^18: scaled, both stay under 2^58.
SCALE_BITS = 40


def to_words(argb: torch.Tensor) -> torch.Tensor:
    """int32 ARGB bits → int64 words in 0..2^32-1."""
    return argb.to(I64) & 0xFFFFFFFF


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v):
    return [(v >> s) & 0xFF for s in (24, 16, 8, 0)]


def _pack(chans):
    a, r, g, b = chans
    return (a << 24) | (r << 16) | (g << 8) | b


def _select(l, t, tl):
    """L when the T-TL gradient is the smaller (the format's crossed
    names), else T."""
    cl, ct, ctl = _channels(l), _channels(t), _channels(tl)
    p_l = sum((a - c).abs() for a, c in zip(ct, ctl))
    p_t = sum((a - c).abs() for a, c in zip(cl, ctl))
    return torch.where(p_l < p_t, l, t)


def _casf(l, t, tl):
    return _pack([(a + b - c).clamp(0, 255) for a, b, c in
                  zip(_channels(l), _channels(t), _channels(tl))])


def _cash(l, t, tl):
    def half(a, c):
        return (a + torch.div(a - c, 2, rounding_mode="trunc")).clamp(0, 255)

    return _pack([half(a, c) for a, c in
                  zip(_channels(_avg2(l, t)), _channels(tl))])


def apply_predictor(mode: int, l, t, tl, tr):
    """Predictor ``mode`` (0..13) from the L, T, TL, TR words."""
    if mode == 0:
        return torch.full_like(l, BLACK)
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(l, tr), t)
    if mode == 6:
        return _avg2(l, tl)
    if mode == 7:
        return _avg2(l, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(l, tl), _avg2(t, tr))
    if mode == 11:
        return _select(l, t, tl)
    if mode == 12:
        return _casf(l, t, tl)
    if mode == 13:
        return _cash(l, t, tl)
    raise ValueError(f"predictor mode {mode} is not in 0..13")


def _neighbors(x):
    """L, T, TL, TR planes of the (H, W) words, 0 outside the image; TR
    of the last column is the current row's first pixel."""
    L = torch.zeros_like(x)
    T = torch.zeros_like(x)
    TL = torch.zeros_like(x)
    TR = torch.zeros_like(x)
    L[:, 1:] = x[:, :-1]
    T[1:] = x[:-1]
    TL[1:, 1:] = x[:-1, :-1]
    TR[1:, :-1] = x[:-1, 1:]
    TR[1:, -1] = x[1:, 0]
    return L, T, TL, TR


def predict_plane(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Prediction of every pixel of the (H, W) int64 words under ``mode``,
    with the decoder's edge rules: row 0 → L, column 0 → T, the origin →
    black."""
    L, T, TL, TR = _neighbors(x)
    pred = apply_predictor(mode, L, T, TL, TR)
    pred[0, 1:] = L[0, 1:]
    pred[1:, 0] = T[1:, 0]
    pred[0, 0] = BLACK
    return pred


def _sub_pixels(x, p):
    """Byte-wise (x - p) mod 256 of int64 words."""
    lo = ((x | 0x01000100) - (p & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) | 0x01000100) - ((p >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return lo | (hi << 8)


def _fixed(v: np.ndarray) -> np.ndarray:
    """float64 → int64 scaled by 2^SCALE_BITS, rounded to nearest."""
    return np.rint(np.ldexp(np.asarray(v, np.float64), SCALE_BITS)).astype(
        np.int64)


def stage1_table() -> np.ndarray:
    """Stage 1's int64 table: n log2 n for n in 0..MAX_COUNT, then the
    magnitude bias 0.04 * min(b, 256 - b) of each byte b."""
    n = np.arange(MAX_COUNT + 1, dtype=np.float64)
    nlogn = n * np.log2(np.maximum(n, 1.0))
    b = np.arange(256)
    bias = 0.04 * np.minimum(b, 256 - b)
    return np.concatenate([_fixed(nlogn), _fixed(bias)])


def refine_table(glob: np.ndarray, mcount: np.ndarray, tiles: int) -> np.ndarray:
    """A refinement round's int64 table from the integer histogram
    ``glob`` (1024 bins: 4 channels x 256) of the current picks'
    residuals and the tiles' mode counts: -log2((glob + 0.1) /
    (channel total + 25.6)) for each bin, then each mode's cost
    -log2((count + 0.1) / (tiles + 1.4))."""
    g = np.asarray(glob, np.float64).reshape(4, 256)
    tot = g.sum(axis=1, keepdims=True)
    nlogp = -np.log2((g + 0.1) / (tot + 25.6))
    mode_cost = -np.log2((np.asarray(mcount, np.float64) + 0.1)
                         / (tiles + 1.4))
    return np.concatenate([_fixed(nlogp.reshape(-1)), _fixed(mode_cost)])


def add_green_inverse(argb: torch.Tensor) -> torch.Tensor:
    """The add-green inverse of int32 ARGB bits (any shape): green added to
    red and blue, mod 256; elementwise torch ops on any device."""
    from .kernels.vp8l_inverse import add_green_words, to_bits

    return to_bits(add_green_words(to_words(argb)))


def check_search(argb, bits: int, refine_iters: int) -> None:
    if argb.dim() != 2 or argb.shape[0] < 1 or argb.shape[1] < 1:
        raise ValueError(f"predictor_search_entropy: argb must be a non-empty "
                         f"(H, W) tensor, got {tuple(argb.shape)}")
    if argb.dtype != torch.int32:
        raise TypeError(f"predictor_search_entropy: argb must be int32 "
                        f"(the ARGB words' bits), got {argb.dtype}")
    if not MIN_BITS <= bits <= MAX_BITS:
        raise ValueError(f"predictor_search_entropy: bits must be in "
                         f"{MIN_BITS}..{MAX_BITS}, got {bits}")
    if refine_iters < 0:
        raise ValueError(f"predictor_search_entropy: refine_iters must be "
                         f">= 0, got {refine_iters}")

__all__ = ["add_green_inverse", "apply_predictor", "predict_plane",
           "predictor_inverse", "predictor_search_entropy", "refine_table",
           "stage1_table", "to_words"]
