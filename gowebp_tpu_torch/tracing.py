"""The port's one recorder of spans and counters.

An entry call (``decode_rgba_batch``, ``encode_rgba_batch``,
``encode_rgba_batch_pipelined``) traces itself when its caller passes a
``timings`` dict, or when ``torch.profiler`` is recording as it enters.
It then opens a ``Recorder`` and marks the host work of each layer with
spans on whatever thread runs it:

- a span has a name, the thread's native id, its start and end in
  Unix-epoch nanoseconds (``time.time_ns()``: the clock on which
  ``torch.profiler`` stamps host events, so the spans line up with the
  profiler's own export), the thread's CPU nanoseconds over it, its
  parent span, the id of its entry call (the call's own span, shared by
  every span of that call on every thread) and a few integer attributes
  (files, bytes, group index; on ``decode.pack`` the pack's ``K``, the
  group's ``blocks`` and ``zero_blocks``, and its ``tail_rows`` and
  ``exc_rows``, the blocks the pack sent past K and raw);
- device stages are ``StageClock`` marks (CUDA events on the card),
  resolved once, when the entry call ends.

With ``timings`` the spans go to ``timings["spans"]``, their sums to the
host-seconds keys each entry call documents, the device stages to
``timings["stage_ms"]`` and the counters beside them.  Under the profiler
they go to a bounded buffer in this module, read by ``recorded()``.
With neither, the entry call holds ``None`` for its recorder and every
span site is one ``is None`` test: nothing is allocated and no clock is
read.  The port emits no ``record_function`` or NVTX range: the profiler
would copy those onto the device's timeline.

Counters: ``kernels.loads`` (a CUDA library built or opened,
``ops/kernels/cuda_build.py``) and ``spans.dropped`` (spans the full
buffer turned away), read by ``counters()``.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

BUFFER_SPANS = 1 << 20          # spans the profiler's buffer holds
# span attributes that ``timings`` also sums, under the same key
COUNTED = ("h2d_bytes", "d2h_bytes", "kernels.loads")

_wall_ns = time.time_ns
_cpu_ns = time.thread_time_ns
_ids = itertools.count(1)
_lock = threading.Lock()
_buffer: list = []
_counters = {"kernels.loads": 0, "spans.dropped": 0}


class StageClock:
    """Stage boundaries of one batch: CUDA events on the current stream
    (device time), or the host clock on the CPU (which computes
    synchronously)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.names, self.stamps = [], []
        self("start")

    def __call__(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())
        self.names.append(name)

    def spans_ms(self) -> dict:
        """Milliseconds per stage; waits for the last mark."""
        if self.cuda:
            self.stamps[-1].synchronize()
        return self.passed_ms()

    def passed_ms(self) -> dict:
        """Milliseconds per stage, once the device passed the last mark."""
        if self.cuda:
            ms = [a.elapsed_time(b) for a, b in zip(self.stamps, self.stamps[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]
        return dict(zip(self.names[1:], ms))


class Span:
    """One stretch of host work on one thread (times in ns)."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns",
                 "end_ns", "cpu_ns", "attrs")

    def __init__(self, name: str, parent, call):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.call = self.id if call is None else call
        self.thread = threading.get_native_id()
        self.attrs = None
        self.end_ns = None
        self.start_ns = _wall_ns()
        self.cpu_ns = -_cpu_ns()   # the thread's clock inside the wall span

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, thread={self.thread}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns}, "
                f"cpu_ns={self.cpu_ns}, attrs={self.attrs})")


class Recorder:
    """The spans and device stages of one entry call.  ``sums`` maps a
    span name to the ``timings`` key that gathers its seconds."""

    def __init__(self, name: str, timings, buffered: bool, sums: dict):
        self.timings, self.buffered, self.sums = timings, buffered, sums
        self.spans, self.clocks = [], []
        self.loads = _counters["kernels.loads"]
        self.call = Span(name, None, None)

    def begin(self, name: str, parent: Span | None = None) -> Span:
        """A span opened on this thread, a child of ``parent`` (default:
        the entry call's span)."""
        return Span(name, (parent or self.call).id, self.call.id)

    def end(self, span: Span, **attrs) -> None:
        span.cpu_ns += _cpu_ns()
        span.end_ns = _wall_ns()
        if attrs:
            span.attrs = attrs
        self.spans.append(span)

    def clock(self, device: torch.device) -> StageClock | None:
        """A stage clock for one batch's device stages, resolved when the
        call ends; None unless the caller gathers ``timings``."""
        if self.timings is None:
            return None
        clock = StageClock(device)
        self.clocks.append(clock)
        return clock

    def finish(self, **attrs) -> None:
        """Resolve the stage clocks (one wait for the device), close the
        call's span and hand the spans to ``timings`` and the buffer."""
        if any(c.cuda for c in self.clocks):
            torch.cuda.synchronize()
        stages = [c.passed_ms() for c in self.clocks]
        attrs["kernels.loads"] = _counters["kernels.loads"] - self.loads
        self.end(self.call, **attrs)
        tm = self.timings
        if tm is not None:
            _gather(tm, self.spans, self.sums, stages)
        if self.buffered:
            with _lock:
                kept = self.spans[:BUFFER_SPANS - len(_buffer)]
                _buffer.extend(kept)
                _counters["spans.dropped"] += len(self.spans) - len(kept)


def _gather(tm: dict, spans: list, sums: dict, stages: list) -> None:
    for key in sums.values():
        tm.setdefault(key, 0.0)
    for s in spans:
        key = sums.get(s.name)
        if key is not None:
            tm[key] += (s.end_ns - s.start_ns) * 1e-9
        if s.attrs:
            for k in COUNTED:
                if k in s.attrs:
                    tm[k] = tm.get(k, 0) + s.attrs[k]
    if stages:
        stage = tm.setdefault("stage_ms", {})
        for ms in stages:
            for k, v in ms.items():
                stage[k] = stage.get(k, 0.0) + v
    tm.setdefault("spans", []).extend(spans)


def recorder(name: str, timings, sums: dict) -> Recorder | None:
    """The recorder of one entry call named ``name``, or None when its
    caller passed no ``timings`` and the profiler is not recording."""
    buffered = torch.autograd._profiler_enabled()
    if timings is None and not buffered:
        return None
    return Recorder(name, timings, buffered, sums)


def recorded() -> list:
    """The spans recorded while ``torch.profiler`` was on, oldest call
    first (the buffer keeps the first ``BUFFER_SPANS``)."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    """Empty the buffer that ``recorded()`` reads."""
    with _lock:
        _buffer.clear()
        _counters["spans.dropped"] = 0


def counters() -> dict:
    """The process's counters: ``kernels.loads``, ``spans.dropped``."""
    with _lock:
        return dict(_counters)


def count(name: str) -> None:
    """Add one to counter ``name``."""
    with _lock:
        _counters[name] += 1


__all__ = ["BUFFER_SPANS", "Recorder", "Span", "StageClock", "clear",
           "count", "counters", "recorded", "recorder"]
