"""Host thread time of the coefficient pack per file, from
``timings["pack_s"]`` (summed over the symbol threads).  Absent where no
lossy file was decoded."""

NAME = "decode.pack_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "coefficient pack (ops/coeff_pack.py, the native pack)"
MOVES = "decode_mps"


def read(ctx):
    if (ctx.op != "decode" or not ctx.timed_items
            or not ctx.timings.get("pack_s")):
        return None
    return ctx.timings["pack_s"] * 1e3 / ctx.timed_items
