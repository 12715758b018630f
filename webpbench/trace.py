"""Reads torch.profiler's trace of a window: each device operation (kernels,
copies, fills) with its start and length, the harness's own host spans
("call", "between_calls") around the calls, the device's busy time, and the
breakdown the result line carries."""

from __future__ import annotations

from dataclasses import dataclass, field

SPANS = ("call", "between_calls")


@dataclass
class Trace:
    ops: list = field(default_factory=list)      # (name, start_s, dur_s)
    spans: list = field(default_factory=list)    # (name, start_s, end_s)

    def kernels(self, fragment: str) -> list:
        """Durations (s) of the device operations whose name holds
        ``fragment``, in launch order."""
        return [d for n, _, d in sorted(self.ops, key=lambda o: o[1])
                if fragment in n]

    def window(self):
        calls = [s for s in self.spans if s[0] == "call"]
        if not calls:
            return None
        return min(s[1] for s in calls), max(s[2] for s in calls)

    def busy_intervals(self):
        win = self.window()
        if win is None:
            return []
        lo, hi = win
        iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.ops
                    if s + d > lo and s < hi)
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        win = self.window()
        return 0.0 if win is None else win[1] - win[0]

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, _, d in self.ops:
            by_name[n] = by_name.get(n, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        busy = self.busy_intervals()
        win = self.window()
        if win is not None:
            edges = [win[0]] + [x for iv in busy for x in iv] + [win[1]]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((self.host_span_at((a + b) / 2), b - a))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}

    def host_span_at(self, t: float) -> str:
        for n, a, b in self.spans:
            if a <= t < b:
                return n
        return "outside_spans"


def _events(prof):
    """(name, is_device, start_ns, duration_ns) of every profiled event,
    read from kineto's results as they are (parsing them into function
    events takes far longer)."""
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" in str(e.device_type()).lower()
        yield e.name(), dev, e.start_ns(), e.duration_ns()


def read(prof) -> Trace:
    tr = Trace()
    for name, dev, start, dur in _events(prof):
        if name in SPANS:
            # the host span; its device-side copy is no device work
            if not dev:
                tr.spans.append((name, start * 1e-9, (start + dur) * 1e-9))
            continue
        if dev and dur > 0:
            tr.ops.append((name, start * 1e-9, dur * 1e-9))
    tr.spans.sort(key=lambda s: s[1])
    return tr


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False, profile_memory=False)


def span(name: str):
    from torch.profiler import record_function

    return record_function(name)
