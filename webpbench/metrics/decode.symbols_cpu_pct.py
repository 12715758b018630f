"""CPU time over wall time of the decode's host symbol work: the
``decode.symbols`` and ``decode.pack`` spans of the timed half
(``timings["spans"]``), each the thread's CPU nanoseconds
(CLOCK_THREAD_CPUTIME_ID) over its wall span.  Well under 100 says the
symbol-engine threads waited for a core or for the interpreter lock; it
does not say that they computed slowly.  Beside the value, the same
ratio of each span name alone."""

NAME = "decode.symbols_cpu_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "decode host (models/vp8/decoder.py, entropy/native/vp8_dec_batch.cpp)"
MOVES = "decode_mps"
SPANS = ("decode.symbols", "decode.pack")


def read(ctx):
    spans = ctx.timings.get("spans")
    if ctx.op != "decode" or not spans:
        return None
    cpu = {k: 0 for k in SPANS}
    wall = {k: 0 for k in SPANS}
    for s in spans:
        if s.name in cpu:
            cpu[s.name] += s.cpu_ns
            wall[s.name] += s.end_ns - s.start_ns
    if sum(cpu.values()) <= 0 or sum(wall.values()) <= 0:
        return None
    out = {"value": 100.0 * sum(cpu.values()) / sum(wall.values())}
    for k in SPANS:
        if wall[k] > 0:
            out[k.split(".")[1]] = 100.0 * cpu[k] / wall[k]
    return out
