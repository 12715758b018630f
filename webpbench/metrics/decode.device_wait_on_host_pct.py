"""Share of the traced window in which no kernel, copy or fill ran on the
card while the program's launching thread sat in ``decode.wait``: blocked
on a symbol-engine group (or a VP8L file) that its host threads had not
finished.

Read from the device trace's busy intervals and the program's own spans
(``gowebp_tpu_torch.tracing.recorded()``, on the profiler's clock) of
the calls in the window.  Beside the value:
  by_span          the whole idle share (``decode.device_idle_pct``)
                   split by the innermost span open on the launching
                   thread: ``decode.wait``, ``decode.device`` (a group's
                   enqueue and copies), the rest of ``decode.call``, and
                   ``outside`` the program (the harness);
  loads_in_window  CUDA libraries built or opened by the window's calls;
  clock_slack_ms   the farthest any ``decode.call`` lies outside the
                   harness's ``call`` span around it.
No value where the program records no spans, or where the two clocks
disagree by more than 1 ms."""

from webpbench.bench import log

NAME = "decode.device_wait_on_host_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "decode host (models/vp8/decoder.py, entropy/native/vp8_dec_batch.cpp)"
MOVES = "decode_mps"
MAX_SLACK_S = 1e-3


def _gaps(busy, lo, hi):
    """The complement of sorted, disjoint ``busy`` within [lo, hi]."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _iv(s):
    return s.start_ns * 1e-9, s.end_ns * 1e-9


def read(ctx):
    win = ctx.trace.window()
    if ctx.op != "decode" or win is None or not ctx.trace.ops:
        return None
    try:
        from gowebp_tpu_torch.tracing import recorded
    except ImportError as e:
        log(f"{NAME}: the program records no spans ({e!r})")
        return None
    lo, hi = win
    spans = recorded()
    calls = [s for s in spans if s.name == "decode.call"
             and s.end_ns * 1e-9 > lo and s.start_ns * 1e-9 < hi]
    harness = [(a, b) for n, a, b in ctx.trace.spans if n == "call"]
    if not calls or not harness:
        log(f"{NAME}: no decode.call span in the traced window")
        return None
    slack = 0.0
    for c in calls:
        a, b = _iv(c)
        h = max(harness, key=lambda h: min(b, h[1]) - max(a, h[0]))
        slack = max(slack, h[0] - a, b - h[1])
    if slack > MAX_SLACK_S:
        log(f"{NAME}: a decode.call lies {slack * 1e3:.3f} ms outside the "
            f"harness's call span: the clocks disagree")
        return None
    ids = {c.id: c.thread for c in calls}
    child = {"decode.wait": [], "decode.device": []}
    for s in spans:
        if s.name in child and ids.get(s.call) == s.thread:
            child[s.name].append(_iv(s))
    idle = _gaps(ctx.trace.busy_intervals(), lo, hi)
    in_call = _overlap(idle, sorted(_iv(c) for c in calls))
    pct = {k: 100.0 * _overlap(idle, sorted(v)) / (hi - lo)
           for k, v in child.items()}
    rest = 100.0 * in_call / (hi - lo) - sum(pct.values())
    outside = 100.0 * (sum(b - a for a, b in idle) - in_call) / (hi - lo)
    return {"value": pct["decode.wait"],
            "by_span": {**pct, "decode.call": rest, "outside": outside},
            "loads_in_window": sum((c.attrs or {}).get("kernels.loads", 0)
                                   for c in calls),
            "clock_slack_ms": slack * 1e3, "calls": len(calls)}
