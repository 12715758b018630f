"""Work of one ``wavefront_fixed`` launch: the closed-loop encode of a chunk
of images with every macroblock's modes given.

Operations per macroblock, counted per 4x4 block from the arithmetic the
encode needs (adds, multiplies, shifts, compares, clamps): the prediction,
forward transform, quantization, dequantization, inverse transform and the
add-and-clip of each of the 16 luma and 8 chroma blocks, plus an i16
macroblock's Y2 path (the DC gather, Walsh-Hadamard pair, its quantization)
and the chroma DC error diffusion.  Bytes: each source pixel read once, the
modes and segment read once, every level (400 int16 a macroblock) and every
reconstructed pixel written once.  The same whatever implements it.
"""

OPS_FDCT, OPS_IDCT, OPS_QUANT, OPS_DEQUANT = 160, 164, 96, 16
OPS_PRED_I16, OPS_PRED_B4 = 32, 80
OPS_RES_RECON = 16 + 48
_BLOCK = OPS_FDCT + OPS_QUANT + OPS_DEQUANT + OPS_IDCT + OPS_RES_RECON
OPS_I16_MB = 16 * (OPS_PRED_I16 + _BLOCK) + 64 + OPS_QUANT + 16 + 72
OPS_I4_MB = 16 * (OPS_PRED_B4 + _BLOCK)
OPS_UV_MB = 8 * (OPS_PRED_I16 + _BLOCK) + 80
BYTES_MB = 384 + 20 + 2 * 400 + 384


def count(n_mb: int, n_i4: int):
    """(int32 operations, bytes) of a launch over ``n_mb`` macroblocks of
    which ``n_i4`` code 4x4 modes."""
    ops = n_i4 * OPS_I4_MB + (n_mb - n_i4) * OPS_I16_MB + n_mb * OPS_UV_MB
    return ops, n_mb * BYTES_MB
