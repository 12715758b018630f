"""Share of the traced window in which no kernel, copy or fill ran on the
card, in the decode cells."""

NAME = "decode.device_idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "decode_mps"


def read(ctx):
    win = ctx.trace.window_s()
    if ctx.op != "decode" or win <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / win)
