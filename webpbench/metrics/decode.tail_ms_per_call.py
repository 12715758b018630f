"""The part of a decode call that its host symbol work does not overlap:
from the end of the call's last ``decode.wait`` (the launching thread's
last block on a symbol-engine group or VP8L file) to the end of its
``decode.call``, averaged over the timed half's calls
(``timings["spans"]``).  With the pixels to host memory it holds the
groups' d2h copies that run one after another."""

NAME = "decode.tail_ms_per_call"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "decode pipeline (decode.py)"
MOVES = "decode_mps"


def read(ctx):
    spans = ctx.timings.get("spans")
    if ctx.op != "decode" or not spans:
        return None
    ends = {s.id: s.end_ns for s in spans if s.name == "decode.call"}
    last = {}
    for s in spans:
        if s.name == "decode.wait" and s.call in ends:
            last[s.call] = max(last.get(s.call, 0), s.end_ns)
    if not last:
        return None
    tails = [ends[c] - t for c, t in last.items()]
    return {"value": sum(tails) / len(tails) * 1e-6, "calls": len(tails)}
