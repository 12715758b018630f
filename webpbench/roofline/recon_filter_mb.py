"""Work of ``recon_filter_mb``: the reconstruction and loop filter of lossy
frames, counted from what the reference's decode of each file had to do
(``vp8ref.decode_rgba(..., work=)``), the same whatever implements it.

Operations (int32 adds, multiplies, shifts, compares, clamps), by libwebp's
arithmetic:
- per macroblock the prediction of its 16 luma blocks (16 4x4 predictions
  of an i4 macroblock, or 16 blocks of a whole-block one) and 8 chroma
  blocks;
- per 4x4 block with an AC coefficient the inverse transform and the
  add-and-clip of its residual; per block with only a DC one the DC's
  rounding and the add-and-clip; a block with no coefficient keeps its
  prediction;
- per pixel line across an edge that the frame filters, its threshold
  tests (the normal filter's seven, or the simple filter's one), and for
  each line that passes them the filter that it takes: the normal filter's
  high-variance test, then the 2-tap update where the variance is high,
  else the 6-tap update of a macroblock edge or the 4-tap one of an inner
  edge; the simple filter's 2-tap update.
Not counted: the i16 macroblocks' Y2 transform.  Bytes: every coefficient
(384 int16), the modes (18) and filter parameters (8) of a macroblock read
once, every reconstructed pixel (384) written once.
"""

OPS_IDCT, OPS_PRED_I16, OPS_PRED_B4 = 164, 32, 80
OPS_RES_RECON = 16 + 48
OPS_DC = 2                                  # (dc + 4) >> 3
OPS_TEST_NORMAL = 7 + 6 * 3 + 6             # 4|p0-q0|+|p1-q1|; 6 |x-y|; and
OPS_TEST_SIMPLE = 7
OPS_HEV = 3                                 # two compares and an or
OPS_TAP2 = 6 + 2 * 4 + 2 * 3                # a; a1, a2; p0, q0
OPS_TAP6 = 8 + 3 * 3 + 6 * 3                # a; a1..a3; six pixels
OPS_TAP4 = 2 + 2 * 4 + 2 + 4 * 3            # a; a1, a2; a3; four pixels
BYTES_MB = 2 * 384 + 18 + 8 + 384


def filter_ops(lines: dict) -> int:
    """Operations of the loop filter: ``lines`` maps a kind of edge to
    [lines tested, lines that pass, of those with high edge variance]."""
    ops = 0
    for kind, (tested, passed, high) in lines.items():
        if kind == "simple":
            ops += tested * OPS_TEST_SIMPLE + passed * OPS_TAP2
            continue
        tap = OPS_TAP6 if kind == "mb" else OPS_TAP4
        ops += (tested * OPS_TEST_NORMAL + passed * OPS_HEV + high * OPS_TAP2
                + (passed - high) * tap)
    return ops


def count(works):
    """(int32 operations, bytes) of the decode of files whose reference
    decodes did ``works`` (one dict a file; a VP8L file's is empty and
    adds nothing)."""
    ops = nbytes = 0
    for w in works:
        if "mb" not in w:
            continue
        n_mb, n_i4 = w["mb"], w["i4"]
        ops += (n_mb * 8 * OPS_PRED_I16 + n_i4 * 16 * OPS_PRED_B4
                + (n_mb - n_i4) * 16 * OPS_PRED_I16
                + w["blocks_ac"] * (OPS_IDCT + OPS_RES_RECON)
                + w["blocks_dc"] * (OPS_DC + OPS_RES_RECON)
                + filter_ops(w["filter"]))
        nbytes += n_mb * BYTES_MB
    return ops, nbytes
