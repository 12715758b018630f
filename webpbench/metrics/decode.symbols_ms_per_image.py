"""Host thread time of the decode's symbol engine per file, from
``timings["symbols_s"]`` (summed over its threads).  Absent where no
lossy file was decoded."""

NAME = "decode.symbols_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "decode host (models/vp8/decoder.py, entropy/native/vp8_dec_batch.cpp)"
MOVES = "decode_mps"


def read(ctx):
    if (ctx.op != "decode" or not ctx.timed_items
            or not ctx.timings.get("symbols_s")):
        return None
    return ctx.timings["symbols_s"] * 1e3 / ctx.timed_items
