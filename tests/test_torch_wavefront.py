"""PyTorch port: the fixed-mode wavefront's plain version vs the JAX
package's XLA wavefront and its Pallas kernel (interpret mode), on CPU,
bit for bit."""

import numpy as np
import pytest
import torch

from gowebp_tpu.models.vp8.encoder import (_default_cost_tables, make_quants,
                                           quality_to_q)
from gowebp_tpu.ops.encode_wavefront_jax import encode_wavefront_core as wf_jax
from gowebp_tpu_torch.ops.encode_wavefront import encode_wavefront_core
from gowebp_tpu_torch.ops.kernels.wavefront_fixed import (
    active_rows, wavefront_fixed, wavefront_fixed_plain)
from gowebp_tpu_torch.ops.vp8_recon import num_diagonals

KEYS = ("y_levels", "y2_levels", "uv_levels", "recon_y", "recon_u", "recon_v")


def _case(B, H, W, seed, quality, i4_share):
    """Random planes, 4 live segments with distinct quantizers, and
    random forced decisions (all 4 whole-block and all 10 B-modes)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (B, H, W)).astype(np.int32)
    u = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    v = rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.int32)
    mh, mw = H // 16, W // 16
    q = make_quants(quality_to_q(quality))
    row = np.array([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                    q.uv_dc.q, q.uv_ac.q], np.int32)
    qs = np.broadcast_to(row, (B, 4, 6)).copy()
    qs[:, 1] = np.clip(qs[:, 1] * 2, 1, 255)
    qs[:, 2] = np.clip(qs[:, 2] // 2, 4, None)
    qs[:, 3] = np.clip(qs[:, 3] + 9, 1, 255)
    seg = rng.integers(0, 4, (B, mh, mw)).astype(np.int32)
    modes = (rng.integers(0, 4, (B, mh, mw)).astype(np.int32),
             rng.integers(0, 4, (B, mh, mw)).astype(np.int32),
             (rng.random((B, mh, mw)) < i4_share).astype(np.int32),
             rng.integers(0, 10, (B, mh, mw, 16)).astype(np.int32))
    return y, u, v, seg, qs, modes


def _torch_args(y, u, v, seg, qs, modes):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return ((t(y.astype(np.uint8)), t(u.astype(np.uint8)),
             t(v.astype(np.uint8)), t(seg), t(qs)),
            tuple(t(m) for m in modes))


@pytest.mark.parametrize("derr", [False, True])
@pytest.mark.parametrize("shape,quality,i4_share", [
    ((2, 48, 64), 75.0, 0.5),     # non-square MB grid, i16/i4 mix
    ((1, 16, 80), 40.0, 0.3),     # one MB row
    ((2, 64, 32), 90.0, 0.8),     # tall: diagonals hold several rows
])
def test_plain_matches_jax_xla_wavefront(derr, shape, quality, i4_share):
    y, u, v, seg, qs, modes = _case(*shape, seed=11 + int(derr),
                                    quality=quality, i4_share=i4_share)
    tables = tuple(t.astype(np.int32) for t in _default_cost_tables())
    want = wf_jax(y, u, v, seg, qs, tables, try_i4=True, modes=modes,
                  want_recon=True, use_derr=derr)
    planes, tmodes = _torch_args(y, u, v, seg, qs, modes)
    got = encode_wavefront_core(*planes, modes=tmodes, want_recon=True,
                                use_derr=derr)
    for k in KEYS + ("ymode", "uvmode", "is_i4", "imodes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_plain_without_recon_matches_levels():
    y, u, v, seg, qs, modes = _case(1, 32, 48, seed=3, quality=75.0,
                                    i4_share=0.5)
    planes, tmodes = _torch_args(y, u, v, seg, qs, modes)
    full = wavefront_fixed_plain(*planes, *tmodes, use_derr=True,
                                 want_recon=True)
    lean = wavefront_fixed(*planes, *tmodes, use_derr=True, want_recon=False)
    assert set(lean) == {"y_levels", "y2_levels", "uv_levels"}
    for k in lean:
        assert lean[k].dtype == torch.int16
        assert torch.equal(lean[k], full[k]), k


def test_plain_matches_pallas_interpret():
    from gowebp_tpu.ops.pallas.wavefront_fixed import wavefront_fixed_pallas

    y, u, v, seg, qs, modes = _case(1, 32, 48, seed=5, quality=40.0,
                                    i4_share=0.5)
    want = wavefront_fixed_pallas(y, u, v, seg, qs, modes, use_derr=True,
                                  want_recon=True, interpret=True)
    planes, tmodes = _torch_args(y, u, v, seg, qs, modes)
    got = wavefront_fixed_plain(*planes, *tmodes, use_derr=True,
                                want_recon=True)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("mw,mh", [(1, 1), (4, 3), (3, 4), (64, 64)])
def test_active_rows_cover_every_mb_once(mw, mh):
    seen = []
    for t in range(num_diagonals(mw, mh)):
        lo, hi = active_rows(t, mh, mw)
        seen += [(my, t - 2 * my) for my in range(lo, hi + 1)]
    assert sorted(seen) == [(my, mx) for my in range(mh) for mx in range(mw)]


def test_cuda_source_tables_match_python():
    """The constant tables compiled into the CUDA header equal the
    Python ones the plain versions use."""
    import re

    from gowebp_tpu_torch.models.vp8.tables import ZIGZAG
    from gowebp_tpu_torch.ops.kernels.cuda_build import KERNEL_DIR
    from gowebp_tpu_torch.ops.kernels.i4_search import MODE4_BITS256
    from gowebp_tpu_torch.ops.vp8_recon import _B4_IDX

    text = (KERNEL_DIR / "vp8_dsp.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", text).group(1)
        return [int(x) for x in body.replace("\n", " ").split(",")]

    def x_macro(name):
        """Rows of the X(...) entries of ``#define name(X)``."""
        body = re.search(r"#define " + name + r"\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                         text).group(1)
        return [[int(v) for v in m.split(",")]
                for m in re.findall(r"X\(([\d, ]+)\)", body)]

    assert x_macro("VP8_ZIGZAG") == [[n, z] for n, z in enumerate(ZIGZAG)]
    b4 = np.asarray(_B4_IDX).reshape(8, 16)
    assert x_macro("VP8_B4_PIXELS") == [[k] + b4[:, k].tolist()
                                        for k in range(16)]
    assert table("kMode4Bits256") == list(MODE4_BITS256)
    nibbles = int(re.search(r"kInvZigzagNibbles = (0x[0-9A-F]+)ull",
                            text).group(1), 16)
    assert [(nibbles >> (4 * k)) & 15 for k in range(16)] == [
        list(ZIGZAG).index(k) for k in range(16)]
