"""Share of its roofline that ``wavefront_fixed`` reaches: the least time
the card could take for the work of the traced window's encodes, over the
device time of the kernel's launches there.

The hybrid engine (cold="i16", refine=1) runs the closed loop twice over
every image: over the cold round's modes, all i16, then over the final
modes, which the output file's first partition gives.  The count is linear
in macroblocks, so the share does not depend on how the program groups
images into launches."""

from webpbench.bench import load_module
from webpbench.peaks import bound_s

NAME = "wavefront_fixed_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels (ops/kernels/*.cu)"
MOVES = "encode_mps"


def read(ctx):
    if ctx.op != "encode":
        return None
    times = ctx.trace.kernels("wavefront_fixed_kernel")
    if not times:
        return None
    count = load_module("roofline", "wavefront_fixed").count
    ops = nbytes = 0
    for idx in ctx.orders:
        for i in idx:
            f = ctx.frame(int(i))
            n_mb, n_i4 = f.mb_w * f.mb_h, int(f.is_i4.sum())
            for launch in ((n_mb, 0), (n_mb, n_i4)):
                o, b = count(*launch)
                ops, nbytes = ops + o, nbytes + b
    t, by = bound_s(ops, nbytes, ctx.ops_per_s)
    return {"value": 100.0 * t / sum(times), "bound_by": by,
            "launches": len(times)}
