"""CPU time over wall time of the encode's token emission: the
``encode.emit`` spans (one an image) of the timed half
(``timings["spans"]``), each its thread's CPU nanoseconds over its wall
span.  Well under 100 says the emission threads waited for a core or
for the interpreter lock."""

NAME = "encode.emit_cpu_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "encode host (models/vp8/encoder.py, entropy/native/encode.cpp)"
MOVES = "encode_mps"


def read(ctx):
    spans = ctx.timings.get("spans")
    if ctx.op != "encode" or not spans:
        return None
    emit = [s for s in spans if s.name == "encode.emit"]
    cpu = sum(s.cpu_ns for s in emit)
    wall = sum(s.end_ns - s.start_ns for s in emit)
    if cpu <= 0 or wall <= 0:
        return None
    return {"value": 100.0 * cpu / wall, "spans": len(emit)}
