"""PyTorch port, the batch decode's sparse coefficient upload
(ops/coeff_pack.py and the unpack kernel's plain version) against the JAX
package's ops/coeff_pack.py, bit for bit.

- The native ``pack_coeffs`` gives the reference's dict, array for array,
  at K = 4, 8 and 16 (both packages' ``_choose_k`` forced to K), on
  seeded coefficients with i16 DC lanes, tails, levels above 127 and
  non-exact divisions.  The reference pads its tables to a power of two
  (>= 16) with index ``nblocks`` and zero rows, for XLA's compiles; the
  port's tables hold exactly their rows, which equal the reference's
  first rows, and the rest of the reference's are padding.
- The native pack == ``pack_coeffs_plain`` (numpy), at forced and chosen
  K, and on real symbols.
- ``unpack_coeffs_plain`` of a pack is the dense input, and equals the
  reference's ``unpack_coeffs`` (JAX on the CPU), on the port's dict and
  on the reference's padded one.
- ``decode_rgba_batch(device="cpu")`` still gives the reference's pixels
  on a mixed batch.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gowebp_tpu
from gowebp_tpu.ops import coeff_pack as jpack
from gowebp_tpu_torch import decode_rgba_batch
from gowebp_tpu_torch.ops import coeff_pack as ppack
from gowebp_tpu_torch.ops.kernels.coeff_unpack import (unpack_coeffs,
                                                       unpack_coeffs_plain)

from util import pil_encode_lossless, pil_encode_lossy

TABLES = ("tail_idx", "tail_val", "exc_idx", "exc_val")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = {"3x(4x5)": (1, 3, 4, 5), "1x(1x1)": (2, 1, 1, 1),
         "2x(1x5)": (3, 2, 1, 5), "2x(5x1)": (4, 2, 5, 1)}


def _case(name, exceptions=True):
    return _chip_smoke().coeff_case(*CASES[name], exceptions=exceptions)


def _force_k(monkeypatch, K):
    monkeypatch.setattr(jpack, "_choose_k", lambda *a: K)
    monkeypatch.setattr(ppack, "_choose_k", lambda *a: K)


def _assert_same_dict(ours, ref, nblocks):
    assert list(ours) == list(ref)
    for k in ours:
        a, b = ours[k], np.asarray(ref[k])
        if k in TABLES:
            n = len(a)
            pad = nblocks if k.endswith("idx") else 0
            assert (b[n:] == pad).all(), k
            b = b[:n]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_native_pack_equals_reference(monkeypatch, name, K):
    _force_k(monkeypatch, K)
    c = _case(name)
    ours, k = ppack.pack_coeffs(*c)
    ref, rk, _cap = jpack.pack_coeffs(*c)
    assert k == rk == K
    assert len(ours["exc_idx"]) > 0 or c[0].size < 2000
    _assert_same_dict(ours, ref, c[0].shape[0] * c[0].shape[1] * 24)
    if K < 16:
        assert len(ours["tail_idx"]) > 0


@pytest.mark.parametrize("K", [4, 8, 16, None])
@pytest.mark.parametrize("name", list(CASES))
def test_native_pack_equals_plain(monkeypatch, name, K):
    if K is not None:
        _force_k(monkeypatch, K)
    c = _case(name, exceptions=name != "2x(1x5)")
    ours, k = ppack.pack_coeffs(*c)
    plain, pk = ppack.pack_coeffs_plain(*c)
    assert k == pk
    assert list(ours) == list(plain)
    for key in ours:
        assert ours[key].dtype == plain[key].dtype, key
        np.testing.assert_array_equal(ours[key], plain[key], err_msg=key)
    assert ppack.packed_nbytes(ours) == sum(a.nbytes for a in plain.values())


def test_choose_k_keeps_the_reference_form(monkeypatch):
    """With the reference's row charge, the port chooses the reference's
    K on any counts; the port's own charge is a measured constant."""
    monkeypatch.setattr(ppack, "_ROW_COST", jpack._ROW_COST)
    rng = np.random.default_rng(0)
    for _ in range(500):
        nblocks = int(rng.integers(24, 10 ** 7))
        n_base = int(rng.integers(0, nblocks // 20 + 1))
        n_t8 = int(rng.integers(0, nblocks - n_base + 1))
        n_t4 = n_t8 + int(rng.integers(0, nblocks - n_base - n_t8 + 1))
        assert ppack._choose_k(nblocks, n_base, n_t4, n_t8) == \
            jpack._choose_k(nblocks, n_base, n_t4, n_t8)


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_unpack_plain_round_trip_and_reference(monkeypatch, name, K):
    _force_k(monkeypatch, K)
    c = _case(name)
    ours, _ = ppack.pack_coeffs(*c)
    ref, _, _ = jpack.pack_coeffs(*c)
    want = np.asarray(jpack.unpack_coeffs(
        {k: jnp.asarray(v) for k, v in ref.items()}, K=K))
    np.testing.assert_array_equal(want, c[0].astype(np.int32))
    for packed in (ours, ref):      # the reference's padding is dropped
        got = unpack_coeffs({k: torch.from_numpy(np.asarray(v))
                             for k, v in packed.items()})
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), c[0])
        np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_unpack_plain_reference_order(monkeypatch):
    """Out-of-range table rows are skipped; an exception row replaces a
    block's tail (exceptions land last); a segment id above 3 takes
    segment 0's quantizers, as the reference's select does."""
    _force_k(monkeypatch, 4)
    c = _case("3x(4x5)")
    ours, _ = ppack.pack_coeffs(*c)
    nblocks = c[0].shape[0] * c[0].shape[1] * 24
    t = int(ours["tail_idx"][0])
    packed = dict(ours)
    packed["exc_idx"] = np.concatenate(
        [ours["exc_idx"], [t, nblocks, -1]]).astype(np.int32)
    packed["exc_val"] = np.concatenate(
        [ours["exc_val"], np.full((3, 16), 77, np.int16)])
    packed["seg"] = ours["seg"].copy()
    packed["seg"][0, 0] = 7
    packed["qmat"] = ours["qmat"].copy()
    packed["qmat"][0, 0] = packed["qmat"][0, 3]
    got = unpack_coeffs_plain({k: torch.from_numpy(v)
                               for k, v in packed.items()})
    ref = {k: jnp.asarray(v) for k, v in packed.items()}
    want = np.asarray(jpack.unpack_coeffs(ref, K=4))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    assert (got.numpy().reshape(-1, 16)[t] == 77).all()


def _symbols(datas):
    from gowebp_tpu_torch.container.riff import parse_riff
    from gowebp_tpu_torch.models.vp8.decoder import decode_vp8_symbols

    out = [decode_vp8_symbols(parse_riff(d).find(b"VP8 ").payload)
           for d in datas]
    coeffs = np.stack([c for _, c, _ in out])
    modes = np.stack([m for _, _, m in out])
    qmat = np.stack([st.quant_rows() for st, _, _ in out])
    return coeffs, modes[..., 2], modes[..., 0], qmat


@pytest.mark.parametrize("quality", [5, 75, 100])
def test_pack_of_real_symbols(quality):
    """Files of the JAX encoder (q100: levels past int8): the chosen K,
    native == plain == the reference, and the round trip."""
    rng = np.random.default_rng(quality)
    imgs = [rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
            for _ in range(2)]
    datas = [gowebp_tpu.encode_rgba(im, quality=quality) for im in imgs]
    c = _symbols(datas)
    ours, k = ppack.pack_coeffs(*c)
    plain, pk = ppack.pack_coeffs_plain(*c)
    assert k == pk
    for key in ours:
        np.testing.assert_array_equal(ours[key], plain[key], err_msg=key)
    got = unpack_coeffs({key: torch.from_numpy(v) for key, v in ours.items()})
    np.testing.assert_array_equal(got.numpy(), c[0])
    if quality == 100:
        assert len(ours["exc_idx"]) > 0


def test_decode_batch_matches_reference_on_a_mixed_batch():
    """Lossy files of two sizes (one at q100, with exception rows), lossy
    + ALPH and VP8L: the packed upload's pixels equal the reference's."""
    rng = np.random.default_rng(17)

    def img(h, w, c=3):
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)

    datas = [gowebp_tpu.encode_rgba(img(33, 47), quality=q)
             for q in (20, 75, 100)]
    datas += [pil_encode_lossy(img(16, 24), quality=80),
              pil_encode_lossy(img(33, 47, 4), quality=60),
              pil_encode_lossless(img(17, 9, 4))]
    want = gowebp_tpu.decode_rgba_batch(datas, recon_backend="jax")
    timings = {}
    got = decode_rgba_batch(datas, device="cpu", threads=2, timings=timings)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert timings["h2d_bytes"] > 0 and timings["pack_s"] > 0
