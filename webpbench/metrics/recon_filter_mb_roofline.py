"""Share of its roofline that ``recon_filter_mb`` reaches: the least time
the card could take for the work of every file that the traced window's
calls decoded, over the device time of the kernel's launches there.  The
work of each file is what the reference's decode of it did
(roofline/recon_filter_mb.py), so the share does not depend on how the
program groups files into launches."""

from webpbench.bench import load_module
from webpbench.peaks import bound_s

NAME = "recon_filter_mb_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (ops/kernels/*.cu)"
MOVES = "decode_mps"


def read(ctx):
    if ctx.op != "decode":
        return None
    times = ctx.trace.kernels("recon_filter_mb_kernel")
    files = [int(i) for idx in ctx.orders for i in idx]
    if not times or any(i not in ctx.work for i in files):
        return None
    count = load_module("roofline", "recon_filter_mb").count
    t, by = bound_s(*count(ctx.work[i] for i in files), ctx.ops_per_s)
    return {"value": 100.0 * t / sum(times), "bound_by": by,
            "launches": len(times)}
