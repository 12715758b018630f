"""Host thread time of token emission per image, from the pipeline's
``timings["emit_thread_s"]`` (summed over its emission threads)."""

NAME = "encode.emit_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "encode host (models/vp8/encoder.py, entropy/native/encode.cpp)"
MOVES = "encode_mps"


def read(ctx):
    if (ctx.op != "encode" or not ctx.timed_items
            or "emit_thread_s" not in ctx.timings):
        return None
    return ctx.timings["emit_thread_s"] * 1e3 / ctx.timed_items
