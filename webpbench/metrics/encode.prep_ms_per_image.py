"""Host thread time of the encode's chunk preparation (RGB to YUV, the
segment analysis) per image, from the pipeline's ``timings["prep"]``."""

NAME = "encode.prep_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "encode pipeline (ops/encode_pipeline.py: YUV, segmentation)"
MOVES = "encode_mps"


def read(ctx):
    if ctx.op != "encode" or not ctx.timed_items or "prep" not in ctx.timings:
        return None
    return ctx.timings["prep"] * 1e3 / ctx.timed_items
