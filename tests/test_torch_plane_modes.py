"""PyTorch port: the plane kernels' modes-only forms and the hybrid cold
round that runs them, against the JAX package on CPU, bit for bit
(tolerance 0: the codec is integer math).

- ``encode_modes`` (the plain versions ``encode_luma_modes_plain`` and
  ``encode_chroma_modes_plain`` on CPU tensors) against the JAX
  ``openloop_mode_search(..., try_i4=False)`` and against the modes of the
  TPU kernels ``_run_luma``/``_run_chroma`` in interpret mode, on random,
  flat (every mode ties), checkerboard and gradient planes, on odd MB
  grids, one MB row and one MB column;
- the port's ``openloop_mode_search(..., try_i4=False)`` (which takes its
  modes from ``encode_modes``) against the JAX one, all four outputs;
- the hybrid core runs the modes-only path once a chunk on its cold round
  with ``cold="i16"`` and ``refine`` >= 1 (also without i4), and never
  with ``cold="dense"`` or ``refine=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gowebp_tpu.models.vp8.encoder import _default_cost_tables
from gowebp_tpu.ops import encode_wavefront_jax as W
from gowebp_tpu.ops.pallas.encode_plane import _run_chroma, _run_luma
from gowebp_tpu_torch.config import EncoderConfig
from gowebp_tpu_torch.ops.encode_pipeline import encode_rgba_batch_pipelined
from gowebp_tpu_torch.ops.encode_wavefront import openloop_mode_search
from gowebp_tpu_torch.ops.kernels import encode_plane as ep
from gowebp_tpu_torch.utils.corpus import natural_image

TABLES = _default_cost_tables()
QUANTS = (8192, 96 << 9, 7710, 110 << 9)   # any: the modes ignore them
_luma_jit = jax.jit(_run_luma, static_argnums=(1, 2))
_chroma_jit = jax.jit(_run_chroma, static_argnums=(2, 3))
_mode_search_jit = jax.jit(W.openloop_mode_search,
                           static_argnames=("try_i4",))


def plane_set(kind, B, H, W_, seed):
    """uint8 (y, u, v) of one kind: random, flat (one value a plane:
    every mode ties), checkerboard (0/255 cells of one pixel: large
    SSEs) or gradient (smooth ramps: TM, VE and HE close)."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w, c in ((H, W_, 93), (H // 2, W_ // 2, 130), (H // 2, W_ // 2, 61)):
        yy, xx = np.mgrid[0:h, 0:w]
        if kind == "random":
            p = rng.integers(0, 256, (B, h, w))
        elif kind == "flat":
            p = np.full((B, h, w), c)
        elif kind == "checkerboard":
            p = np.broadcast_to(((yy + xx) & 1) * 255, (B, h, w))
        else:
            p = np.stack([(c + 90 * xx / w + 60 * yy / h + 7 * i) % 256
                          for i in range(B)])
        out.append(np.ascontiguousarray(p).astype(np.uint8))
    return tuple(out)


KINDS = ("random", "flat", "checkerboard", "gradient")
SHAPES = ((2, 48, 80),    # 3 x 5 MBs
          (1, 16, 80),    # one MB row
          (1, 80, 16))    # one MB column


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_modes_plain_match_jax(kind, shape):
    B, H, W_ = shape
    y, u, v = plane_set(kind, B, H, W_, seed=H * W_)
    ymode, uvmode = ep.encode_modes(*(torch.from_numpy(p) for p in (y, u, v)))
    assert ymode.dtype == uvmode.dtype == torch.uint8
    assert ymode.shape == uvmode.shape == (B, H // 16, W_ // 16)

    # the TPU kernels in interpret mode
    j = [jnp.asarray(p.astype(np.int32)) for p in (y, u, v)]
    jl = np.asarray(_luma_jit(j[0], QUANTS, True)[2])[:, :, ::16]
    jc = np.asarray(_chroma_jit(j[1], j[2], QUANTS, True)[2])[:, :, ::8]
    np.testing.assert_array_equal(ymode.numpy(), jl)
    np.testing.assert_array_equal(uvmode.numpy(), jc)

    # the JAX mode search without i4, all four outputs, against the port's
    seg = np.zeros((B, H // 16, W_ // 16), np.int32)
    qs = np.full((B, 4, 6), 24, np.int32)
    want = _mode_search_jit(
        *j, jnp.asarray(seg), jnp.asarray(qs),
        tuple(jnp.asarray(t.astype(np.int32)) for t in TABLES), try_i4=False)
    got = openloop_mode_search(
        *(torch.from_numpy(p) for p in (y, u, v)), torch.from_numpy(seg),
        torch.from_numpy(qs),
        tuple(torch.from_numpy(t.astype(np.int32)) for t in TABLES),
        try_i4=False, i4_penalty=torch.zeros((B, 4), dtype=torch.int32))
    for k in ("ymode", "uvmode", "is_i4", "imodes"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["ymode"].numpy(), ymode.numpy())
    if kind == "flat":       # away from the edge fills every mode ties
        assert not ymode[:, 1:, 1:].any() and not uvmode[:, 1:, 1:].any()


def test_modes_wrappers_route_cpu_tensors_to_plain_versions():
    y, u, v = (torch.from_numpy(p)
               for p in plane_set("random", 2, 32, 48, seed=3))
    launches = (ep.encode_luma_modes.launches,
                ep.encode_chroma_modes.launches)
    calls = (ep.encode_luma_modes_plain.calls,
             ep.encode_chroma_modes_plain.calls)
    ymode, uvmode = ep.encode_modes(y, u, v)
    assert (ep.encode_luma_modes.launches,
            ep.encode_chroma_modes.launches) == launches
    assert (ep.encode_luma_modes_plain.calls,
            ep.encode_chroma_modes_plain.calls) == tuple(n + 1 for n in calls)
    # the modes of the full plane kernels' plain versions
    assert torch.equal(ymode, ep.encode_luma_plain(y, QUANTS, QUANTS)[0])
    assert torch.equal(uvmode, ep.encode_chroma_plain(u, v, QUANTS)[0])
    with pytest.raises(ValueError, match="unsupported device"):
        ep.encode_luma_modes(y.to("meta"))


@pytest.mark.parametrize("opts,calls", [
    (dict(cold="i16", refine=1), 1),
    (dict(cold="i16", refine=2), 1),
    (dict(config=EncoderConfig(lossless=False, method=3)), 1),  # no i4
    (dict(cold="dense", refine=1), 0),
    (dict(cold="i16", refine=0), 0),
])
def test_hybrid_cold_round_runs_modes_only_path(opts, calls):
    """One chunk: the cold round of cold="i16" with refine >= 1 takes its
    modes from the modes-only path (one call of each plain version);
    cold="dense" and refine=0 search i4 there and never call it.  The
    refine rounds (recon context) never do."""
    imgs = [natural_image(48, 64, seed=s) for s in (1, 2)]
    before = (ep.encode_luma_modes_plain.calls,
              ep.encode_chroma_modes_plain.calls)
    out = encode_rgba_batch_pipelined(imgs, quality=75.0, chunk=2,
                                      device="cpu", **opts)
    assert len(out) == 2
    assert (ep.encode_luma_modes_plain.calls - before[0],
            ep.encode_chroma_modes_plain.calls - before[1]) == (calls, calls)
