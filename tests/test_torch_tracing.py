"""The port's tracer (gowebp_tpu_torch/tracing.py) on the CPU: tracing off
records nothing and reads no clock; the spans of a traced batch decode
and encode (nesting, call ids, threads, CPU time, the sums ``timings``
reports); a ``decode.call`` on the profiler's clock; the ``kernels.loads``
counter; and the benchmark's readers of the spans, against values worked
by hand."""

import ctypes.util
import io
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from gowebp_tpu_torch import decode_rgba_batch, encode_rgba_batch, tracing
from gowebp_tpu_torch.ops.encode_pipeline import encode_rgba_batch_pipelined
from gowebp_tpu_torch.utils.corpus import natural_image
from webpbench.bench import load_module
from webpbench.layers import LayerContext
from webpbench.trace import Trace


def _webp(rgba, **kw):
    b = io.BytesIO()
    Image.fromarray(rgba).save(b, "WEBP", **kw)
    return b.getvalue()


def _files():
    """40 lossy files of two sizes (two symbol-engine groups at
    threads=2), two with an ALPH chunk and one VP8L file."""
    rng = np.random.default_rng(3)
    datas = [_webp(natural_image(24 + 8 * (k % 2), 40, seed=k), quality=75)
             for k in range(40)]
    for k in range(2):
        rgba = np.dstack([natural_image(16, 16, seed=50 + k),
                          rng.integers(0, 256, (16, 16), dtype=np.uint8)])
        datas.append(_webp(rgba, quality=80))
    datas.append(_webp(natural_image(16, 24, seed=60), lossless=True))
    return datas


DATAS = _files()
IMAGES = [natural_image(32, 48, seed=70 + k) for k in range(5)]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.fixture
def no_clock(monkeypatch):
    """Any span, stage clock or tracing clock read raises."""
    def boom(*a, **k):
        raise AssertionError("tracing ran with tracing off")

    monkeypatch.setattr(tracing, "_wall_ns", boom)
    monkeypatch.setattr(tracing, "_cpu_ns", boom)
    monkeypatch.setattr(tracing, "Span", boom)
    monkeypatch.setattr(tracing, "StageClock", boom)
    monkeypatch.setattr(tracing, "Recorder", boom)


@pytest.mark.parametrize("entry", ["decode", "decode_host", "encode"])
def test_tracing_off_records_nothing(no_clock, entry):
    before = len(tracing.recorded())
    assert tracing.recorder("decode.call", None, {}) is None
    if entry == "encode":
        got = encode_rgba_batch(IMAGES[:3], device="cpu")
        assert len(got) == 3
    else:
        got = decode_rgba_batch(DATAS, device="cpu", threads=2,
                                recon_backend=entry[7:] or "device")
        assert len(got) == len(DATAS)
    assert len(tracing.recorded()) == before


def test_decode_call_nests_in_a_profiler_range():
    """Under a CPU torch.profiler the call records into the buffer, on
    the profiler's own clock: its decode.call lies inside the
    record_function range around it, to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer_range"):
            decode_rgba_batch(DATAS, device="cpu", threads=2)
    (outer,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "outer_range"]
    a, b = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    spans = _by_name(tracing.recorded())
    (call,) = spans["decode.call"]
    assert a - 1_000_000 <= call.start_ns < call.end_ns <= b + 1_000_000
    assert {"decode.symbols", "decode.pack", "decode.wait",
            "decode.device"} <= set(spans)
    assert tracing.counters()["spans.dropped"] == 0
    tracing.clear()
    assert tracing.recorded() == []


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(tracing, "BUFFER_SPANS", 5)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        decode_rgba_batch(DATAS[:3], device="cpu", threads=1)
    spans = tracing.recorded()
    # decode.symbols, decode.pack and a decode.device a shape group
    # (24x40, 32x40), then the call's own span
    assert len(spans) == 5 and tracing.counters()["spans.dropped"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        decode_rgba_batch(DATAS[:3], device="cpu", threads=1)
    assert tracing.recorded() == spans
    assert tracing.counters()["spans.dropped"] == 5
    tracing.clear()
    assert tracing.counters()["spans.dropped"] == 0


def _check_nesting(spans, call_name):
    by_id = {s.id: s for s in spans}
    (call,) = [s for s in spans if s.name == call_name]
    assert call.parent is None and call.call == call.id
    for s in spans:
        assert s.call == call.id
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns, s
        if s is not call:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s
    return call


def test_decode_spans_nest_on_their_threads():
    timings = {}
    decode_rgba_batch(DATAS, device="cpu", threads=2, timings=timings)
    spans = timings["spans"]
    call = _check_nesting(spans, "decode.call")
    by = _by_name(spans)
    assert call.attrs == {"files": len(DATAS), "groups": 2,
                          "kernels.loads": 0}
    assert len(by["decode.symbols"]) == len(by["decode.pack"]) == 2
    assert len(by["decode.alpha"]) == 2 and len(by["decode.vp8l"]) == 1
    # the caller blocks once a group and once for the VP8L file, and
    # puts each shape group through the device
    assert len(by["decode.wait"]) == 3 and len(by["decode.device"]) == 4
    for s in by["decode.wait"] + by["decode.device"]:
        assert s.thread == call.thread and s.parent == call.id
    for s in by["decode.symbols"] + by["decode.pack"] + by["decode.vp8l"]:
        assert s.thread != call.thread
    assert sorted(s.attrs["group"] for s in by["decode.symbols"]) == [0, 1]
    assert sum(s.attrs["files"] for s in by["decode.symbols"]) == 42
    assert sum(s.attrs["bytes_in"] for s in by["decode.symbols"]) > 0
    dev = by["decode.device"]
    assert sum(s.attrs["files"] for s in dev) == 42
    assert timings["h2d_bytes"] == sum(s.attrs["h2d_bytes"] for s in dev)
    assert timings["d2h_bytes"] == sum(s.attrs["d2h_bytes"] for s in dev)
    assert timings["d2h_bytes"] == 4 * sum(
        int(np.prod(Image.open(io.BytesIO(d)).size)) for d in DATAS[:42])


def _plain_pack_counts(datas, group, ngroups):
    """What ``pack_coeffs_plain`` gives for the lossy files of symbol
    group ``group``, packed by shape group as the decode packs them:
    the summed counts, and K the largest."""
    from gowebp_tpu_torch.container.riff import parse_riff
    from gowebp_tpu_torch.models.vp8.decoder import decode_vp8_symbols
    from gowebp_tpu_torch.ops.coeff_pack import pack_coeffs_plain

    lossy = [parse_riff(d) for d in datas]
    lossy = [r for r in lossy if r.find(b"VP8 ") is not None]
    shapes = {}
    for r in lossy[group::ngroups]:
        st, c, m = decode_vp8_symbols(r.find(b"VP8 ").payload)
        key = (st.width, st.height, st.filter_type,
               r.find(b"ALPH") is not None)
        shapes.setdefault(key, []).append((st, c, m))
    want = {"K": 0, "blocks": 0, "zero_blocks": 0, "tail_rows": 0,
            "exc_rows": 0}
    for recs in shapes.values():
        coeffs = np.stack([c for _, c, _ in recs])
        modes = np.stack([m for _, _, m in recs])
        packed, K = pack_coeffs_plain(
            coeffs, modes[..., 2], modes[..., 0],
            np.stack([st.quant_rows() for st, _, _ in recs]))
        want["K"] = max(want["K"], K)
        want["blocks"] += coeffs.size // 16
        want["zero_blocks"] += int((coeffs.reshape(-1, 16) == 0).all(1).sum())
        want["tail_rows"] += len(packed["tail_idx"])
        want["exc_rows"] += len(packed["exc_idx"])
    return want


def test_pack_span_counts_equal_the_plain_pack():
    """Each ``decode.pack`` span carries its group's K and block and row
    counts, those of ``pack_coeffs_plain`` on the same files: two
    symbol groups of two sizes with ALPH files (tail rows; the small ALPH
    group takes K = 16, the largest), and q100 files (K = 16, an
    exception row)."""
    q100 = [_webp(natural_image(32, 40, seed=1 + k), quality=100)
            for k in range(3)]
    for datas, threads in ((DATAS, 2), (q100, 1)):
        timings = {}
        decode_rgba_batch(datas, device="cpu", threads=threads,
                          timings=timings)
        packs = _by_name(timings["spans"])["decode.pack"]
        assert len(packs) == threads
        for s in packs:
            want = _plain_pack_counts(datas, s.attrs["group"], threads)
            assert {k: s.attrs[k] for k in want} == want
            assert 0 < want["zero_blocks"] < want["blocks"]
            if threads == 1:
                assert want["K"] == 16 and want["exc_rows"] > 0
            else:
                assert want["tail_rows"] > 0


def test_span_sums_are_the_timings_seconds():
    timings = {}
    decode_rgba_batch(DATAS, device="cpu", threads=2, timings=timings)
    decode_rgba_batch(DATAS, device="cpu", threads=1, timings=timings)
    by = _by_name(timings["spans"])
    assert len(by["decode.call"]) == 2
    for name, key in (("decode.symbols", "symbols_s"),
                      ("decode.pack", "pack_s"), ("decode.alpha", "alpha_s"),
                      ("decode.vp8l", "vp8l_s")):
        want = sum((s.end_ns - s.start_ns) * 1e-9 for s in by[name])
        assert timings[key] == pytest.approx(want, rel=1e-12), key
        assert timings[key] > 0
    # one thread: no group to wait for, everything on the caller
    (call1,) = [c for c in by["decode.call"] if c.attrs["groups"] == 1]
    assert all(s.thread == call1.thread for s in timings["spans"]
               if s.call == call1.id)


def test_host_backend_spans():
    timings = {}
    decode_rgba_batch(DATAS, device="cpu", threads=2, recon_backend="host",
                      timings=timings)
    by = _by_name(timings["spans"])
    _check_nesting(timings["spans"], "decode.call")
    assert len(by["decode.recon_host"]) == 42 and "decode.pack" not in by
    assert "decode.device" not in by and "stage_ms" not in timings
    assert timings["recon_host_s"] == pytest.approx(
        sum((s.end_ns - s.start_ns) * 1e-9 for s in by["decode.recon_host"]),
        rel=1e-12)


def test_encode_spans_and_sums():
    timings = {}
    got = encode_rgba_batch(IMAGES, device="cpu", threads=2,
                            timings=timings)
    assert len(got) == 5
    spans = timings["spans"]
    call = _check_nesting(spans, "encode.call")
    by = _by_name(spans)
    assert call.attrs == {"images": 5, "chunks": 1, "kernels.loads": 0}
    assert sorted(s.attrs["image"] for s in by["encode.emit"]) == list(range(5))
    assert {"encode.prep", "encode.dispatch", "encode.h2d", "encode.fetch",
            "encode.wait"} <= set(by)
    for s in by["encode.dispatch"] + by["encode.wait"]:
        assert s.thread == call.thread
    (h2d,) = by["encode.h2d"]
    assert h2d.parent == by["encode.dispatch"][0].id
    for name, key in (("encode.prep", "prep"), ("encode.h2d", "h2d"),
                      ("encode.fetch", "fetch"),
                      ("encode.emit", "emit_thread_s"),
                      ("encode.call", "total")):
        want = sum((s.end_ns - s.start_ns) * 1e-9 for s in by[name])
        assert timings[key] == pytest.approx(want, rel=1e-12), key
    # chunks of 2: a prep, a fetch and two emissions waited for a chunk
    timings = {}
    encode_rgba_batch_pipelined(IMAGES, device="cpu", chunk=2, depth=2,
                                timings=timings)
    waits = [s.attrs for s in timings["spans"] if s.name == "encode.wait"]
    assert sorted((w["stage"], w["chunk"]) for w in waits) == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2),
        (2, 0), (2, 0), (2, 1), (2, 1), (2, 2)]


def test_kernels_loads_counts_a_library_opened_once(monkeypatch):
    from gowebp_tpu_torch.ops.kernels.cuda_build import CudaLibrary

    lib = CudaLibrary("vp8_recon.cu", lambda lib: None)
    monkeypatch.setattr(lib, "start_build", lambda: None)
    monkeypatch.setattr(lib, "_so_path",
                        lambda: Path(ctypes.util.find_library("m")))
    before = tracing.counters()["kernels.loads"]
    lib.load()
    lib.load()
    assert tracing.counters()["kernels.loads"] == before + 1


# -- the benchmark's readers of the spans ------------------------------------

def _span(name, sid, call, thread, a_ms, b_ms, cpu_ms=0.0, **attrs):
    return SimpleNamespace(name=name, id=sid, call=call, thread=thread,
                           parent=None if sid == call else call,
                           start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                           cpu_ns=int(cpu_ms * 1e6), attrs=attrs or None)


def _ctx(op="decode", trace=None, spans=()):
    return LayerContext(op=op, timings={"spans": list(spans)}, timed_items=1,
                        trace=trace or Trace(), traced_items=1, orders=[],
                        files={})


def _traced_window(call2_start_ms=12600.0):
    """Two harness calls over a 4.5 s window, the card busy 1 s of it,
    and the program's spans of two calls (worked by hand below)."""
    trace = Trace(ops=[("k", 11.0, 0.5), ("k2", 13.5, 0.5)],
                  spans=[("call", 10.0, 12.0), ("between_calls", 12.0, 12.5),
                         ("call", 12.5, 14.5)])
    spans = [
        _span("decode.call", 1, 1, 7, 10100, 11900, **{"kernels.loads": 1}),
        _span("decode.wait", 2, 1, 7, 10200, 10800),
        _span("decode.device", 3, 1, 7, 10800, 11600),
        _span("decode.symbols", 4, 1, 8, 10150, 10700),
        _span("decode.wait", 5, 1, 8, 10100, 11900),   # not the caller's
        _span("decode.call", 10, 10, 7, call2_start_ms, 14400,
              **{"kernels.loads": 0}),
        _span("decode.wait", 11, 10, 7, 12700, 13700),
        _span("decode.device", 12, 10, 7, 13700, 14300),
    ]
    return trace, spans


def test_device_wait_on_host_by_hand(monkeypatch):
    mod = load_module("metrics", "decode.device_wait_on_host_pct")
    idle_pct = load_module("metrics", "decode.device_idle_pct")
    trace, spans = _traced_window()
    monkeypatch.setattr(tracing, "recorded", lambda: spans)
    got = mod.read(_ctx(trace=trace))
    # idle 3.5 of 4.5 s; in decode.wait 0.6 + 0.8, in decode.device
    # 0.2 + 0.1 + 0.3, the rest of the calls 0.4 + 0.2, outside 0.9
    approx = lambda v: pytest.approx(v, abs=1e-4)  # noqa: E731
    assert got["value"] == approx(100 * 1.4 / 4.5)
    assert got["by_span"] == {"decode.wait": approx(100 * 1.4 / 4.5),
                              "decode.device": approx(100 * 0.6 / 4.5),
                              "decode.call": approx(100 * 0.6 / 4.5),
                              "outside": approx(100 * 0.9 / 4.5)}
    assert sum(got["by_span"].values()) == approx(
        idle_pct.read(_ctx(trace=trace)))
    assert got["loads_in_window"] == 1 and got["calls"] == 2
    assert got["clock_slack_ms"] == 0.0


def test_device_wait_on_host_refuses_clocks_apart(monkeypatch):
    mod = load_module("metrics", "decode.device_wait_on_host_pct")
    trace, spans = _traced_window(call2_start_ms=12498.0)   # 2 ms early
    monkeypatch.setattr(tracing, "recorded", lambda: spans)
    assert mod.read(_ctx(trace=trace)) is None
    trace, spans = _traced_window(call2_start_ms=12499.5)   # 0.5 ms
    got = mod.read(_ctx(trace=trace))
    assert got["clock_slack_ms"] == pytest.approx(0.5, abs=1e-3)


def test_device_wait_on_host_without_the_tracer(monkeypatch):
    """A program without tracing.py (the parent) gives no value and does
    not raise; nor does a trace with no decode.call."""
    mod = load_module("metrics", "decode.device_wait_on_host_pct")
    trace, _ = _traced_window()
    monkeypatch.setattr(tracing, "recorded", lambda: [])
    assert mod.read(_ctx(trace=trace)) is None
    monkeypatch.setitem(sys.modules, "gowebp_tpu_torch.tracing", None)
    assert mod.read(_ctx(trace=trace)) is None
    assert mod.read(_ctx(op="encode", trace=trace)) is None


def test_symbols_cpu_pct_by_hand():
    mod = load_module("metrics", "decode.symbols_cpu_pct")
    spans = [_span("decode.symbols", 2, 1, 8, 0, 100, 80),
             _span("decode.pack", 3, 1, 8, 100, 150, 20),
             _span("decode.wait", 4, 1, 7, 0, 150, 0)]
    got = mod.read(_ctx(spans=spans))
    assert got["value"] == pytest.approx(100 * 100 / 150)
    assert got["symbols"] == pytest.approx(80.0)
    assert got["pack"] == pytest.approx(40.0)
    for s in spans:
        s.cpu_ns = 0
    assert mod.read(_ctx(spans=spans)) is None
    assert mod.read(_ctx(spans=[])) is None
    assert mod.read(_ctx(op="encode", spans=spans)) is None


def test_tail_ms_per_call_by_hand():
    mod = load_module("metrics", "decode.tail_ms_per_call")
    spans = [_span("decode.call", 1, 1, 7, 0, 1000),
             _span("decode.wait", 2, 1, 7, 0, 600),
             _span("decode.wait", 3, 1, 7, 650, 800),
             _span("decode.call", 10, 10, 7, 2000, 2500),
             _span("decode.wait", 11, 10, 7, 2000, 2400)]
    got = mod.read(_ctx(spans=spans))
    assert got["value"] == pytest.approx(150.0) and got["calls"] == 2
    assert mod.read(_ctx(spans=spans[:1])) is None
    assert mod.read(_ctx(op="encode", spans=spans)) is None


def test_emit_cpu_pct_by_hand():
    mod = load_module("metrics", "encode.emit_cpu_pct")
    spans = [_span("encode.emit", 2, 1, 8, 0, 10, 5),
             _span("encode.emit", 3, 1, 9, 0, 30, 15),
             _span("encode.prep", 4, 1, 9, 0, 30, 30)]
    got = mod.read(_ctx(op="encode", spans=spans))
    assert got["value"] == pytest.approx(50.0) and got["spans"] == 2
    assert mod.read(_ctx(op="decode", spans=spans)) is None
    for s in spans:
        s.cpu_ns = 0
    assert mod.read(_ctx(op="encode", spans=spans)) is None


def test_readers_on_a_real_traced_decode():
    """The readers take the program's own spans: a timed call's
    CPU share lies in (0, 100] and its tail inside the call."""
    timings = {}
    decode_rgba_batch(DATAS, device="cpu", threads=2, timings=timings)
    cpu = load_module("metrics", "decode.symbols_cpu_pct").read(
        _ctx(spans=timings["spans"]))
    assert 0 < cpu["value"] <= 100
    tail = load_module("metrics", "decode.tail_ms_per_call").read(
        _ctx(spans=timings["spans"]))
    (call,) = [s for s in timings["spans"] if s.name == "decode.call"]
    assert 0 < tail["value"] < (call.end_ns - call.start_ns) * 1e-6
