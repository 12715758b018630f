"""Device time of the exact engine's ``wavefront_search`` kernel per image
encoded, from the trace."""

NAME = "wavefront_search.device_ms_per_image"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "kernels (ops/kernels/*.cu)"
MOVES = "encode_mps"


def read(ctx):
    if ctx.op != "encode" or not ctx.traced_items:
        return None
    times = ctx.trace.kernels("wavefront_search")
    if not times:
        return None
    return {"value": sum(times) * 1e3 / ctx.traced_items, "launches": len(times)}
