"""The device-to-host copy of the decoded pixels per file, from
``timings["stage_ms"]["d2h"]``: CUDA-event spans on one stream around the
copy.  Absent where the pixels stay on the card."""

NAME = "decode.d2h_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "decode pipeline (decode.py)"
MOVES = "decode_mps"


def read(ctx):
    d2h = ctx.timings.get("stage_ms", {}).get("d2h")
    if ctx.op != "decode" or not ctx.timed_items or not d2h:
        return None
    return d2h / ctx.timed_items
