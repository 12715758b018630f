"""PyTorch port, the encode pipeline's ``depth``: 1, 2 or 3 chunks in
flight (staging ring, fetch thread) give the JAX package's bytes, in image
order, for both engines, on CPU, byte for byte.  Also the export buckets
growing under ``depth``, the host timings, and many emit threads with a
short switch interval."""

import sys

import numpy as np
import pytest

from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined as jax_pipe
from gowebp_tpu_torch.ops import encode_pipeline as pipe
from gowebp_tpu_torch.utils.corpus import natural_image

# 5 images in chunks of 2: the last chunk is partial
IMAGES = [natural_image(48, 64, seed=20 + i) for i in range(5)]


@pytest.fixture(scope="module", params=["hybrid", "openloop"])
def engine_bytes(request):
    """One JAX run per engine."""
    return request.param, jax_pipe(IMAGES, quality=75.0, chunk=2,
                                   engine=request.param)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_matches_jax(engine_bytes, depth):
    engine, want = engine_bytes
    got = pipe.encode_rgba_batch_pipelined(IMAGES, quality=75.0, chunk=2,
                                           device="cpu", engine=engine,
                                           depth=depth)
    assert got == want


def test_buckets_grow_under_depth(monkeypatch, engine_bytes):
    """A first export bucket far too small: every chunk in flight was
    exported at the old buckets, the fetch thread re-exports each one
    that overflows them, and the bytes do not change."""
    engine, want = engine_bytes
    monkeypatch.setattr(pipe, "FIRST_BUCKET", 8)
    calls = []
    real = pipe._export_packed_v2

    def spy(out, *, ks, kb):
        calls.append((ks, kb))
        return real(out, ks=ks, kb=kb)

    monkeypatch.setattr(pipe, "_export_packed_v2", spy)
    got = pipe.encode_rgba_batch_pipelined(IMAGES, quality=75.0, chunk=2,
                                           device="cpu", engine=engine,
                                           depth=3)
    assert got == want
    assert len(calls) > 3, "no chunk was re-exported"
    assert calls[0] == (8, 8) and max(calls)[0] > 8


def test_timings_cover_host_and_device_stages():
    timings = {}
    pipe.encode_rgba_batch_pipelined(IMAGES[:3], quality=75.0, chunk=2,
                                     device="cpu", timings=timings)
    for k in ("prep", "h2d", "fetch", "emit_thread_s", "total"):
        assert timings[k] > 0, k
    assert set(timings["stage_ms"]) == {
        "h2d", "cold", "wavefront1", "refine", "wavefront2", "pack", "d2h"}


def test_many_emit_threads_short_switch_interval():
    """16 emit threads, one image a chunk, depth 3, a thread switch every
    10 us: every image still gets its own file, in order."""
    imgs = [natural_image(16, 32, seed=40 + i) for i in range(8)]
    want = pipe.encode_rgba_batch_pipelined(imgs, chunk=1, device="cpu",
                                            depth=1, threads=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = pipe.encode_rgba_batch_pipelined(imgs, chunk=1, device="cpu",
                                               depth=3, threads=16)
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert len(set(got)) == len(imgs)


def test_staging_ring_reuses_slots_in_turn():
    """Chunk i writes slot i % n; on the CPU an upload is a copy, so the
    next write to the slot cannot change planes already handed out."""
    import torch

    ring = pipe.StagingRing(3, 2, 4, torch.device("cpu"))
    ring.slot(0)[:] = 7
    first = ring.upload(0, 2)
    ring.slot(3)[:] = 9                       # the same slot, reused
    assert torch.equal(first, torch.full((2, 4), 7, dtype=torch.uint8))
    assert np.array_equal(ring.slot(0), np.full((2, 4), 9, np.uint8))
    assert ring.upload(1, 1).shape == (1, 4)
