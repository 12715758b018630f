"""PyTorch port: the exact full-search engine (``engine="wavefront"``)
against the JAX package on CPU, bit for bit (tolerance 0: the codec is
integer math).

- ``wavefront_search_plain`` and ``encode_wavefront_core(modes=None)``
  against the JAX ``encode_wavefront_core(modes=None)`` (XLA), on every
  output and the recon: MB grids 1x1, 1x5, 5x1 and 3x5, q75 and q99 (the
  |level| > 127 escape), UV DC error diffusion on and off, 4 live segments
  with distinct quantizers and penalties, ``try_i4`` on and off;
- the strict adoption: macroblocks whose i4 walk scores exactly the i16
  score keep i16;
- the exact engine's fixed point: from its own recon, the hybrid's mode
  search reproduces its decisions, and the fixed-mode wavefront its levels;
- whole ``.webp`` files of ``encode_rgba_batch(engine="wavefront")`` and
  of the pipelined encoder, for several configs, odd sizes and depths.
"""

import numpy as np
import pytest
import torch

from gowebp_tpu import encode_rgba_batch as jax_batch
from gowebp_tpu.config import EncoderConfig as JaxConfig
from gowebp_tpu.models.vp8.encoder import (_default_cost_tables,
                                           _i4_config_seg, make_quants,
                                           quality_to_q)
from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined as jax_pipe
from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core as wf_jax
from gowebp_tpu_torch import encode_rgba_batch
from gowebp_tpu_torch.config import EncoderConfig
from gowebp_tpu_torch.ops.encode_pipeline import encode_rgba_batch_pipelined
from gowebp_tpu_torch.ops.encode_wavefront import (encode_wavefront_core,
                                                   openloop_mode_search)
from gowebp_tpu_torch.ops.kernels.wavefront_fixed import wavefront_plain
from gowebp_tpu_torch.ops.kernels.wavefront_search import (
    SearchModes, search_tables, wavefront_search, wavefront_search_plain)
from gowebp_tpu_torch.utils.corpus import natural_image

TABLES = tuple(t.astype(np.int32) for t in _default_cost_tables())
TTABLES = tuple(torch.from_numpy(t) for t in TABLES)
MODES = ("ymode", "uvmode", "is_i4", "imodes")
LEVELS = ("y_levels", "y2_levels", "uv_levels")
RECON = ("recon_y", "recon_u", "recon_v")


def mixed_planes(rng, B, H, W):
    """MBs of three kinds at random: noise (i4 wins), flat 128 and a
    gentle gradient (i16 wins); chroma MBs noisy, flat or a plane in x
    and y (which TM predicts)."""
    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W]
    grad = 60 + 100 * xx / W + 50 * yy / H
    kind = rng.integers(0, 3, (B, mh, mw))
    ky = kind.repeat(16, 1).repeat(16, 2)
    y = np.where(ky == 0, rng.integers(0, 256, (B, H, W)),
                 np.where(ky == 1, 128, grad + rng.integers(-2, 3, (B, H, W))))
    kc = rng.integers(0, 3, (B, mh, mw)).repeat(8, 1).repeat(8, 2)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    planes = []
    for lo, hi in ((100, 156), (125, 132)):
        band = rng.integers(lo, hi, (B, H // 2, W // 2))
        planes.append(np.where(kc == 0, band, np.where(
            kc == 1, 128, 40 + 5 * (cx % 8) + 7 * (cy % 8) + (cx // 8))))
    return tuple(np.clip(a, 0, 255).astype(np.int32) for a in (y, *planes))


def _case(B, H, W, quality, seed):
    """Mixed planes, 4 live segments with distinct quantizers and the
    penalties the encoder derives from them."""
    rng = np.random.default_rng(seed)
    y, u, v = mixed_planes(rng, B, H, W)
    rows = []
    for d in (-6, -2, 3, 8):
        q = make_quants(max(0, min(127, quality_to_q(quality) + d)))
        rows.append([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q,
                     q.uv_ac.q])
    rows = np.array(rows, np.int32)
    qs = np.broadcast_to(rows, (B, 4, 6)).copy()
    seg = rng.integers(0, 4, (B, H // 16, W // 16)).astype(np.int32)
    # the encoder's penalties, kept distinct where two quantizers clamp
    pens = np.stack([_i4_config_seg(rows, 4, 0)[1] + 17 * np.arange(4)] * B)
    pens = pens.astype(np.int32)
    return y, u, v, seg, qs, pens


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(y, u, v, seg, qs, pens, *, try_i4, use_derr):
    out = wf_jax(y, u, v, seg, qs, TABLES, try_i4=try_i4, i4_penalty=pens,
                 want_recon=True, use_derr=use_derr)
    return {k: np.asarray(a) for k, a in out.items()}


def _assert_equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == (torch.uint8 if k in MODES + RECON
                                else torch.int16), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("quality,use_derr,try_i4", [
    (75.0, True, True), (75.0, False, True), (99.0, True, True),
    (99.0, False, False), (75.0, True, False)])
@pytest.mark.parametrize("B,H,W", [
    (1, 16, 16),      # 1x1 MB
    (2, 16, 80),      # 1x5: one MB row
    (2, 80, 16),      # 5x1: one MB column
    (2, 48, 80),      # 3x5: diagonals hold several rows
])
def test_plain_matches_jax_full_search(B, H, W, quality, use_derr, try_i4):
    y, u, v, seg, qs, pens = _case(B, H, W, quality, seed=H + W)
    want = _jax(y, u, v, seg, qs, pens, try_i4=try_i4, use_derr=use_derr)
    planes = _t(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8),
                seg, qs)
    got = encode_wavefront_core(*planes, TTABLES, try_i4=try_i4,
                                i4_penalty=torch.from_numpy(pens),
                                want_recon=True, use_derr=use_derr)
    _assert_equal(got, want, MODES + LEVELS + RECON)
    plain = wavefront_search_plain(*planes, torch.from_numpy(pens),
                                   search_tables(TTABLES), try_i4=try_i4,
                                   use_derr=use_derr, want_recon=True)
    _assert_equal(plain, want, MODES + LEVELS + RECON)
    if try_i4 and H * W > 256:       # both kinds of MB were coded
        assert 0 < want["is_i4"].mean() < 1


@pytest.mark.parametrize("quality", [75.0, 99.0])
def test_full_search_cases_reach_what_they_claim(quality):
    """The mixed planes give every ymode and uvmode, and at q99 a level
    past 127 (the pack's escape to dense levels)."""
    y, u, v, seg, qs, pens = _case(2, 48, 80, quality, seed=128)
    out = wavefront_search_plain(
        *_t(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8), seg,
            qs, pens), search_tables(TTABLES), try_i4=True, use_derr=True,
        want_recon=False)
    assert sorted(out["ymode"].unique().tolist()) == [0, 1, 2, 3]
    assert sorted(out["uvmode"].unique().tolist()) == [0, 1, 2, 3]
    assert sorted(out["imodes"][out["is_i4"] == 1].unique().tolist()) == \
        list(range(10))
    assert (int(out["y_levels"].abs().max()) > 127) == (quality == 99.0)


class _Recording(SearchModes):
    """The search, keeping each MB's (s16, s4)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.seen = []

    def scores(self, *a):
        s16, s4, bmodes = super().scores(*a)
        self.seen.append((a[0], s16, s4))
        return s16, s4, bmodes


def test_equal_scores_keep_i16():
    """A flat MB that every mode predicts exactly scores 0 as i16 and as
    i4 where the segment's penalty is 0: the adoption is strict, so it
    stays i16, as in the JAX engine."""
    rng = np.random.default_rng(3)
    y, u, v, seg, qs, pens = _case(1, 48, 64, 75.0, seed=3)
    y[:, :32, :32] = 128                   # 4 flat MBs: pred 128 everywhere
    u[:, :16, :16] = 128
    v[:, :16, :16] = 128
    seg[:] = rng.integers(1, 4, seg.shape)
    seg[:, :2, :2] = 0
    pens[:, 0] = 0
    want = _jax(y, u, v, seg, qs, pens, try_i4=True, use_derr=True)
    args = _t(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8),
              seg, qs)
    rec = _Recording(torch.from_numpy(pens), search_tables(TTABLES), True)
    got = wavefront_plain(*args, rec, use_derr=True, want_recon=True)
    for k in MODES:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    ties = 0
    for (bb, my, mx), s16, s4 in rec.seen:
        for j in range(len(bb)):
            if s4[j] == s16[j]:
                ties += 1
                assert want["is_i4"][bb[j], my[j], mx[j]] == 0
    assert ties >= 1
    assert want["is_i4"].any()             # the noisy MBs still adopt i4


def test_exact_search_is_a_fixed_point_of_the_hybrid_search():
    """From the exact engine's own recon, the hybrid's mode search
    reproduces its decisions, and the fixed-mode wavefront its levels
    (the port's mirror of tests/test_encode_pipeline.py's check)."""
    from gowebp_tpu_torch.models.vp8.encoder import rgb_to_yuv420

    im = natural_image(64, 64, seed=11)[..., :3]
    y, u, v = (torch.from_numpy(p.astype(np.int32))[None]
               for p in rgb_to_yuv420(im))
    q = make_quants(quality_to_q(75.0))
    row = [q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q, q.uv_ac.q]
    qs = torch.tensor([row] * 4, dtype=torch.int32)[None]
    seg = torch.zeros((1, 4, 4), dtype=torch.int32)
    pen = torch.from_numpy(_i4_config_seg(qs[0].numpy(), 4, 0)[1])[None]
    full = encode_wavefront_core(y, u, v, seg, qs, TTABLES, try_i4=True,
                                 i4_penalty=pen)
    assert 0 < full["is_i4"].float().mean() <= 1
    modes = tuple(full[k].to(torch.int32) for k in MODES)
    fixed = encode_wavefront_core(y, u, v, seg, qs, modes=modes,
                                  want_recon=True)
    for k in LEVELS:
        assert torch.equal(full[k], fixed[k]), k
    redo = openloop_mode_search(
        y, u, v, seg, qs, TTABLES, try_i4=True, i4_penalty=pen,
        ctx=(fixed["recon_y"], fixed["recon_u"], fixed["recon_v"]))
    for k in MODES:
        assert torch.equal(full[k].to(torch.int32), redo[k]), k


def test_wrapper_on_cpu_is_the_plain_version():
    y, u, v, seg, qs, pens = _case(1, 32, 48, 75.0, seed=9)
    args = _t(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8),
              seg, qs, pens)
    before = wavefront_search.launches
    got = wavefront_search(*args, search_tables(TTABLES), try_i4=True,
                           use_derr=True, want_recon=False)
    assert wavefront_search.launches == before     # no kernel on the CPU
    assert set(got) == set(MODES + LEVELS)
    lean = wavefront_search(*args[:5], None, None, try_i4=False,
                            use_derr=True, want_recon=False)
    assert not lean["is_i4"].any()


def _imgs(n, h, w, seed=21):
    return [natural_image(h, w, seed=seed + i) for i in range(n)]


def _jax_config(**kw):
    return JaxConfig(lossless=False, quality=75.0, **kw)


@pytest.mark.parametrize("cfg,shape,depth", [
    ({}, (48, 64), 3),                         # default config
    ({"method": 3}, (48, 64), 3),              # no i4 search
    ({"partition_limit": 100}, (48, 64), 3),   # no i4 search either
    ({"segments": 2}, (48, 64), 3),
    ({}, (45, 61), 3),                         # odd size
    ({}, (48, 64), 1),
])
def test_pipelined_wavefront_bytes_match_jax(cfg, shape, depth):
    imgs = _imgs(3, *shape)
    want = jax_pipe(imgs, chunk=2, config=_jax_config(**cfg),
                    engine="wavefront", depth=depth)
    got = encode_rgba_batch_pipelined(
        imgs, chunk=2, device="cpu", engine="wavefront", depth=depth,
        config=EncoderConfig(lossless=False, quality=75.0, **cfg))
    assert got == want


def test_batch_wavefront_bytes_match_jax_and_ignore_hybrid_options():
    imgs = _imgs(2, 40, 56, seed=31)
    want = jax_batch(imgs, quality=75.0, engine="wavefront")
    assert encode_rgba_batch(imgs, device="cpu", engine="wavefront") == want
    # refine, cold and i4_topk belong to the hybrid engine
    assert encode_rgba_batch_pipelined(
        imgs, chunk=2, device="cpu", engine="wavefront", refine=2,
        cold="dense", i4_topk=4) == want


def test_wavefront_stage_is_marked():
    timings = {}
    encode_rgba_batch_pipelined(_imgs(1, 32, 32), device="cpu",
                                engine="wavefront", timings=timings)
    assert set(timings["stage_ms"]) == {"h2d", "wavefront", "pack", "d2h"}
