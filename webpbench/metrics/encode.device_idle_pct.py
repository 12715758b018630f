"""Share of the traced window in which no kernel, copy or fill ran on the
card, in the encode cells."""

NAME = "encode.device_idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "encode_mps"


def read(ctx):
    win = ctx.trace.window_s()
    if ctx.op != "encode" or win <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / win)
