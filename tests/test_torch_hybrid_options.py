"""PyTorch port, the hybrid pipeline's options, against the JAX package on
CPU, bit for bit (tolerance 0: the codec is integer math).

- the top-k B-mode ranking against ``_i4_candidates``, and cost ties that
  the rank order decides (``i4_topk=10`` differs from ``None``);
- the plane-context flat i4 search (``_i4_search_parallel``, the flat
  kernel's plain version) with ``topk`` on odd MB grids, and the mode
  search with the Gauss-Seidel walk or the flat search and ``i4_topk``;
- whole-pipeline bytes for ``cold``/``refine``/``i4_topk`` and for
  ``config``, and no i4 macroblock where the config turns i4 off.

The JAX package runs its XLA i4 search (``GOWEBP_PALLAS_I4`` unset): its
Pallas route ignores ``i4_topk``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gowebp_tpu.config import EncoderConfig as JaxConfig
from gowebp_tpu.models.vp8.encoder import (_default_cost_tables, make_quants,
                                           quality_to_q)
from gowebp_tpu.ops import encode_wavefront_jax as W
from gowebp_tpu.ops.encode_pipeline import encode_rgba_batch_pipelined as jax_pipe
from gowebp_tpu_torch.config import EncoderConfig
from gowebp_tpu_torch.ops.encode_pipeline import encode_rgba_batch_pipelined
from gowebp_tpu_torch.ops.encode_wavefront import (_i4_search_parallel,
                                                   _per_mb,
                                                   openloop_mode_search,
                                                   search_penalty)
from gowebp_tpu_torch.ops.kernels.i4_search import rank_modes, t3_tables
from gowebp_tpu_torch.params import params_from_numpy
from gowebp_tpu_torch.utils.corpus import natural_image

TABLES = _default_cost_tables()
JTABLES = tuple(jnp.asarray(t.astype(np.int32)) for t in TABLES)
# one compilation per shape and option set instead of one per JAX op
jax_flat_search = jax.jit(W._i4_search_parallel, static_argnums=(7, 8, 9),
                          static_argnames=("i4_topk",))
jax_mode_search = jax.jit(W.openloop_mode_search,
                          static_argnames=("try_i4", "i4_parallel", "i4_topk"))


def _t3():
    return t3_tables(tuple(torch.from_numpy(t.astype(np.int32))
                           for t in TABLES))


def _images(n, h, w, seed):
    return [natural_image(h, w, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("k", [1, 4, 10])
def test_rank_modes_matches_jax_candidates(k):
    """Predictions in a narrow range: many equal SSEs, ranked to the
    lower mode as the JAX one-hot top-k does."""
    rng = np.random.default_rng(k)
    S = 512
    preds = rng.integers(126, 131, (S, 10, 4, 4)).astype(np.int32)
    preds[:, 3] = preds[:, 1]                   # exact ties between modes
    src = rng.integers(124, 133, (S, 1, 4, 4)).astype(np.int32)
    _, want, _ = W._i4_candidates(jnp.asarray(preds), jnp.asarray(src), k)
    got = rank_modes(torch.from_numpy(preds), torch.from_numpy(src), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _plane_case(B, mh, mw, seed, spread=4):
    """A flat plane with noise, a context plane near it, 2 of 4 segments
    with distinct quantizers, per-MB lambdas: cost ties happen."""
    rng = np.random.default_rng(seed)
    H, W_ = 16 * mh, 16 * mw
    y = np.clip(128 + rng.integers(-spread, spread + 1, (B, H, W_)), 0, 255)
    cy = np.clip(y + rng.integers(-2, 3, y.shape), 0, 255)
    q = make_quants(quality_to_q(20.0))
    row = [q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q, q.uv_dc.q, q.uv_ac.q]
    qs = np.broadcast_to(np.array(row, np.int32), (B, 4, 6)).copy()
    qs[:, 1, :2] = [10, 12]
    seg = rng.integers(0, 2, (B, mh * mw)).astype(np.int32)
    pen_n = np.take_along_axis(
        rng.integers(50, 2000, (B, 4)).astype(np.int32), seg, 1)
    return y.astype(np.int32), cy.astype(np.int32), seg, pen_n, qs


@functools.lru_cache(maxsize=None)
def _flat_search(B, mh, mw, topk, seed=1):
    """(port, JAX) results of the flat search on one plane case."""
    y, cy, seg, pen_n, qs = _plane_case(B, mh, mw, seed)
    iqs = ((1 << 17) // np.maximum(qs, 1)).astype(np.int32)
    want = jax_flat_search(
        jnp.asarray(y), jnp.asarray(cy), jnp.asarray(seg), jnp.asarray(pen_n),
        jnp.asarray(qs), jnp.asarray(iqs), JTABLES, B, mh, mw, i4_topk=topk)
    segt = torch.from_numpy(seg).long()
    got = _i4_search_parallel(
        torch.from_numpy(y), torch.from_numpy(cy),
        _per_mb(torch.from_numpy(qs), segt), _per_mb(torch.from_numpy(iqs),
                                                     segt),
        torch.from_numpy(pen_n), _t3(), topk)
    return tuple(g.numpy() for g in got), tuple(np.asarray(a) for a in want)


@pytest.mark.parametrize("mh,mw,topk", [
    (1, 1, None), (1, 5, None), (5, 1, None), (3, 5, None),
    (3, 5, 1), (3, 5, 4), (3, 5, 10), (1, 5, 4)])
def test_flat_search_matches_jax_on_odd_grids(mh, mw, topk):
    """The edge rules: 127 on the frame's top row (corner included), 129
    on column 0, the MB's top-right pixels for gx == 3 sub-blocks
    (repeated in the last MB column, 127 in the top MB row); and topk."""
    got, want = _flat_search(2, mh, mw, topk)
    for g, w, name in zip(got, want, ("bmodes", "s4")):
        assert g.shape == w.shape == ((2, mh * mw, 16) if name == "bmodes"
                                      else (2, mh * mw))
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_cost_ties_follow_rank_order():
    """topk=10 keeps every mode but breaks a cost tie to the better-
    predicting mode: here it changes modes (never costs), in both."""
    got_all, want_all = _flat_search(2, 3, 5, None)
    got_10, want_10 = _flat_search(2, 3, 5, 10)
    assert (want_all[0] != want_10[0]).any(), "fixture has no rank-order tie"
    np.testing.assert_array_equal(want_all[1], want_10[1])
    for g, w in zip(got_10 + got_all, want_10 + want_all):
        np.testing.assert_array_equal(g, w)


def _search_case(B, H, W_, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (B, H, W_)).astype(np.int32)
    yy, xx = np.mgrid[0:H, 0:W_]
    y[0] = np.clip(128 + 60 * np.sin(xx / 7.0) + rng.integers(-4, 5, (H, W_)),
                   0, 255)
    u = rng.integers(0, 256, (B, H // 2, W_ // 2)).astype(np.int32)
    v = rng.integers(0, 256, (B, H // 2, W_ // 2)).astype(np.int32)
    q = make_quants(quality_to_q(75.0))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    qs[:, 2, 1] = 9
    seg = rng.integers(0, 4, (B, H // 16, W_ // 16)).astype(np.int32)
    pens = np.array([[900, 400, 2000, 6400]] * B, np.int32)
    recon = tuple(np.clip(p + rng.integers(-3, 4, p.shape), 0, 255)
                  .astype(np.uint8) for p in (y, u, v))
    return y, u, v, seg, qs, pens, recon


@pytest.mark.parametrize("parallel,topk", [
    (False, 1), (False, 4), (False, 10), (True, 4)])
def test_mode_search_topk_matches_jax(parallel, topk):
    """The Gauss-Seidel walk (refine rounds, recon context) and the flat
    plane-context search (the dense cold round, source context) with
    i4_topk, through the whole mode search."""
    y, u, v, seg, qs, pens, recon = _search_case(2, 48, 64, seed=4)
    pen_search = np.minimum((pens * 7) >> 2, (1 << 19) - 1)
    ctx = None if parallel else recon
    want = jax_mode_search(
        y, u, v, seg, qs, JTABLES, try_i4=True,
        i4_penalty=jnp.asarray(pen_search), ctx=ctx, i4_parallel=parallel,
        i4_topk=topk)
    tt, qs_t, seg_t, pens_t = params_from_numpy(TABLES, qs, seg, pens,
                                                device="cpu")
    got = openloop_mode_search(
        *(torch.from_numpy(p) for p in (y, u, v)), seg_t, qs_t, tt,
        try_i4=True, i4_penalty=search_penalty(pens_t),
        ctx=None if ctx is None else tuple(torch.from_numpy(r) for r in ctx),
        i4_parallel=parallel, i4_topk=topk)
    for k in ("ymode", "uvmode", "is_i4", "imodes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert 0 < int(got["is_i4"].sum()) < got["is_i4"].numel()


@pytest.mark.parametrize("cold,refine,i4_topk", [
    ("dense", 1, None), ("i16", 0, None), ("i16", 2, 4), ("dense", 1, 4)])
def test_pipeline_options_match_jax(cold, refine, i4_topk):
    imgs = _images(2, 48, 64, seed=3)
    opts = dict(quality=75.0, chunk=2, engine="hybrid", cold=cold,
                refine=refine, i4_topk=i4_topk)
    got = encode_rgba_batch_pipelined(imgs, device="cpu", **opts)
    assert got == jax_pipe(imgs, **opts)


CONFIGS = {
    "method3": dict(method=3),
    "limit100": dict(partition_limit=100),
    "mix": dict(quality=85.0, method=6, segments=2, sns_strength=80,
                partition_limit=50, filter_strength=30, filter_sharpness=3,
                filter_type=0, partitions=2, qmin=30),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name, monkeypatch):
    """Bytes equal the JAX pipeline's with the same config; where the
    config turns i4 off (method < 4, partition_limit 100) no MB is i4."""
    import gowebp_tpu_torch.ops.encode_pipeline as pipe

    seen = []
    real = pipe.emit_frame_arrays

    def spy(y2, yl, uvl, is_i4, *a, **k):
        seen.append(int(np.asarray(is_i4).sum()))
        return real(y2, yl, uvl, is_i4, *a, **k)

    monkeypatch.setattr(pipe, "emit_frame_arrays", spy)
    imgs = _images(2, 48, 64, seed=11)
    kw = CONFIGS[name]
    got = encode_rgba_batch_pipelined(
        imgs, quality=75.0, chunk=2, device="cpu",
        config=EncoderConfig(lossless=False, **kw))
    want = jax_pipe(imgs, quality=75.0, chunk=2, engine="hybrid",
                    config=JaxConfig(lossless=False, **kw))
    assert got == want
    assert len(seen) == 2
    if name == "mix":
        assert sum(seen) > 0, "fixture never adopts i4"
    else:
        assert sum(seen) == 0, f"i4 MBs emitted with {kw}"


def test_default_config_adopts_i4(monkeypatch):
    """The images of test_config_matches_jax do adopt i4 under the
    default config, so its i4-off cases are not vacuous."""
    import gowebp_tpu_torch.ops.encode_pipeline as pipe

    seen = []
    real = pipe.emit_frame_arrays

    def spy(y2, yl, uvl, is_i4, *a, **k):
        seen.append(int(np.asarray(is_i4).sum()))
        return real(y2, yl, uvl, is_i4, *a, **k)

    monkeypatch.setattr(pipe, "emit_frame_arrays", spy)
    encode_rgba_batch_pipelined(_images(2, 48, 64, seed=11), quality=75.0,
                                chunk=2, device="cpu")
    assert sum(seen) > 0


@pytest.mark.parametrize("kw,err", [
    (dict(refine=-1), ValueError), (dict(cold="sparse"), ValueError),
    (dict(i4_topk=0), ValueError), (dict(i4_topk=11), ValueError),
    (dict(i4_topk=4.0), TypeError)])
def test_bad_options_raise(kw, err):
    with pytest.raises(err):
        encode_rgba_batch_pipelined(_images(1, 16, 16, seed=1), device="cpu",
                                    **kw)
