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
  K, and on real symbols; the edge groups (``EDGES``: every block an
  exception, levels at +-127 and +-128, coefficients one off a multiple,
  eobs of exactly 4, 8 and 16, i16 MBs with only a DC, the tables'
  smallest and largest quantizers, odd MB counts, B = 1 and B = 33) also
  against the reference.
- The scalar path of the native pack (a build without AVX-512) gives the
  vector path's bytes on every group here.
- ``unpack_coeffs_plain`` of a pack is the dense input, and equals the
  reference's ``unpack_coeffs`` (JAX on the CPU), on the port's dict and
  on the reference's padded one.
- ``decode_rgba_batch(device="cpu")`` still gives the reference's pixels
  on a mixed batch.
"""

import ctypes
import functools
import importlib.util
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gowebp_tpu
from gowebp_tpu.ops import coeff_pack as jpack
from gowebp_tpu_torch.entropy import native_loader
from gowebp_tpu_torch import decode_rgba_batch
from gowebp_tpu_torch.ops import coeff_pack as ppack
from gowebp_tpu_torch.ops.kernels.coeff_unpack import (unpack_coeffs,
                                                       unpack_coeffs_plain)
from gowebp_tpu_torch.utils.corpus import natural_image

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


def _from_levels(lv, seg, is_i4, qmat, dc=None):
    """(B, N, 24, 16) zigzag levels times their quantizers, as the raster
    int16 coefficients of the symbol engine; ``dc`` the i16 MBs' luma DC
    lanes (inverse-WHT outputs, any value)."""
    B = lv.shape[0]
    luma = np.arange(24)[:, None] < 16
    col = np.where(luma, np.where(np.arange(16) == 0, 0, 1),
                   np.where(np.arange(16) == 0, 4, 5))
    zz = lv * qmat[np.arange(B)[:, None, None, None],
                   seg[:, :, None, None].astype(np.int64), col[None, None]]
    assert np.abs(zz).max(initial=0) < 2 ** 15
    coeffs = np.zeros_like(zz)
    coeffs[..., [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]] = zz
    if dc is not None:
        i16 = (is_i4 == 0)[:, :, None]
        coeffs[:, :, :16, 0] = np.where(i16, dc, coeffs[:, :, :16, 0])
    return coeffs.astype(np.int16), seg, is_i4, qmat


def _edge(name):
    """The pack's edge groups → (coeffs, seg, is_i4, qmat)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, N = {"b1_odd_mbs": (1, 7), "b33": (33, 3)}.get(name, (2, 5))
    seg = rng.integers(0, 4, (B, N)).astype(np.uint8)
    is_i4 = rng.integers(0, 2, (B, N)).astype(np.uint8)
    qmat = rng.integers(4, 201, (B, 4, 6)).astype(np.int32)
    dc = rng.integers(-2000, 2001, (B, N, 16))
    shape = (B, N, 24, 16)
    lv = rng.integers(-30, 31, shape) * (rng.random(shape) < 0.3)
    if name == "all_exceptions":
        c, *rest = _from_levels(lv, seg, is_i4, qmat, dc)
        c[..., 1] += 1            # raster 1 = zigzag 1, an AC lane: q >= 4
        return (c, *rest)
    if name == "levels_127_128":
        qmat = rng.integers(4, 256, (B, 4, 6)).astype(np.int32)
        lv = rng.choice([-128, -127, -126, 0, 0, 126, 127, 128], shape)
        lv *= rng.random(shape) < 0.2
        return _from_levels(lv, seg, is_i4, qmat, dc)
    if name == "one_off":
        c, *rest = _from_levels(lv, seg, is_i4, qmat, dc)
        flat = c.reshape(-1, 16)
        rows = rng.choice(len(flat), len(flat) // 4, replace=False)
        flat[rows, rng.integers(0, 16, len(rows))] += rng.choice(
            np.array([-1, 1], np.int16), len(rows))
        return (c, *rest)
    if name == "eob_4_8_16":
        eob = rng.choice([1, 3, 4, 5, 8, 9, 15, 16], shape[:3])
        pos = np.arange(16)
        lv = np.where(pos < eob[..., None], lv, 0)
        last = rng.integers(1, 31, shape[:3]) * rng.choice([-1, 1], shape[:3])
        lv = np.where(pos == eob[..., None] - 1, last[..., None], lv)
        return _from_levels(lv, seg, np.ones_like(is_i4), qmat)
    if name == "i16_dc_only":
        is_i4 = np.zeros_like(is_i4)
        return _from_levels(np.zeros(shape, np.int64), seg, is_i4, qmat, dc)
    if name == "q_min_max":
        # kDcTable runs 4-157 (uv_dc capped at 132), kAcTable 4-284
        for col, hi in ((0, 157), (1, 284), (4, 132), (5, 284)):
            qmat[..., col] = rng.choice([4, hi], (B, 4))
        lv = rng.integers(-115, 116, shape) * (rng.random(shape) < 0.3)
        return _from_levels(lv, seg, is_i4, qmat, dc)
    c, *rest = _from_levels(lv, seg, is_i4, qmat, dc)  # odd MBs, B = 33
    flat = c.reshape(-1)
    flat[rng.choice(flat.size, flat.size // 100, replace=False)] += 1
    return (c, *rest)


EDGES = ("all_exceptions", "levels_127_128", "one_off", "eob_4_8_16",
         "i16_dc_only", "q_min_max", "b1_odd_mbs", "b33")


def _case(name, exceptions=True):
    if name in EDGES:
        return _edge(name)
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
@pytest.mark.parametrize("name", list(CASES) + list(EDGES))
def test_native_pack_equals_reference(monkeypatch, name, K):
    _force_k(monkeypatch, K)
    c = _case(name)
    ours, k = ppack.pack_coeffs(*c)
    ref, rk, _cap = jpack.pack_coeffs(*c)
    assert k == rk == K
    _assert_same_dict(ours, ref, c[0].shape[0] * c[0].shape[1] * 24)
    nblocks = c[0].shape[0] * c[0].shape[1] * 24
    if name in CASES:
        assert len(ours["exc_idx"]) > 0 or c[0].size < 2000
        if K < 16:
            assert len(ours["tail_idx"]) > 0
    elif name == "all_exceptions":
        assert len(ours["exc_idx"]) == nblocks
        assert not ours["lv8"].any() and len(ours["tail_idx"]) == 0
    elif name == "levels_127_128":
        assert len(ours["exc_idx"]) > 0 and (ours["lv8"] == 127).any()
        assert (ours["lv8"] == -127).any() and not (ours["lv8"] == -128).any()
    elif name == "eob_4_8_16" and K < 16:
        assert len(ours["tail_idx"]) > 0 and len(ours["exc_idx"]) == 0
    elif name == "i16_dc_only":
        assert not ours["lv8"].any() and ours["dc16"].any()
        assert len(ours["tail_idx"]) == len(ours["exc_idx"]) == 0


@pytest.mark.parametrize("K", [4, 8, 16, None])
@pytest.mark.parametrize("name", list(CASES) + list(EDGES))
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


@functools.lru_cache(maxsize=None)
def _real32(quality):
    """The symbols of 32 libwebp (Pillow) files of one size: a group as
    the batch decode packs it."""
    return _symbols([pil_encode_lossy(natural_image(48, 64, seed=k),
                                      quality=quality) for k in range(32)])


@pytest.mark.parametrize("quality", [5, 75, 100])
def test_pack_of_32_real_files(monkeypatch, quality):
    """32 libwebp files in one group: native == plain at the chosen K,
    == the reference's first rows at that K, and the round trip."""
    c = _real32(quality)
    ours, k = ppack.pack_coeffs(*c)
    plain, pk = ppack.pack_coeffs_plain(*c)
    assert k == pk
    for key in ours:
        np.testing.assert_array_equal(ours[key], plain[key], err_msg=key)
    monkeypatch.setattr(jpack, "_choose_k", lambda *a: k)
    ref, _, _ = jpack.pack_coeffs(*c)
    _assert_same_dict(ours, ref, c[0].shape[0] * c[0].shape[1] * 24)
    got = unpack_coeffs({key: torch.from_numpy(v) for key, v in ours.items()})
    np.testing.assert_array_equal(got.numpy(), c[0])


@pytest.fixture(scope="module")
def scalar_lib(tmp_path_factory):
    """The native pack built without AVX-512, so its scalar path."""
    so = tmp_path_factory.mktemp("scalar_pack") / "libpack_scalar.so"
    subprocess.run(["g++", *native_loader._FLAGS, "-mno-avx512f", "-o",
                    str(so), str(native_loader._NATIVE_DIR / "vp8_dec.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    main = native_loader.get_lib()
    for f in ("wtpu_vp8_pack_scan", "wtpu_vp8_pack_emit"):
        getattr(lib, f).argtypes = getattr(main, f).argtypes
        getattr(lib, f).restype = getattr(main, f).restype
    return lib


@pytest.mark.parametrize("K", [4, 8, 16, None])
@pytest.mark.parametrize("name", list(CASES) + list(EDGES)
                         + ["real32_q5", "real32_q75", "real32_q100"])
def test_scalar_pack_equals_vector_pack(monkeypatch, scalar_lib, name, K):
    """The scalar path gives the bytes of the library the port loads
    (its AVX-512 path, on a host that has AVX-512)."""
    if K is not None:
        _force_k(monkeypatch, K)
    c = _real32(int(name[8:])) if name.startswith("real32") else _case(name)
    vec, kv = ppack.pack_coeffs(*c)
    monkeypatch.setattr(ppack, "get_lib", lambda: scalar_lib)
    sca, ks = ppack.pack_coeffs(*c)
    assert kv == ks and list(vec) == list(sca)
    for key in vec:
        assert vec[key].dtype == sca[key].dtype, key
        np.testing.assert_array_equal(vec[key], sca[key], err_msg=key)


@pytest.mark.parametrize("bad", ["coeffs", "seg", "is_i4", "qmat"])
def test_pack_images_rejects_shapes_that_do_not_fit(bad):
    """Per-image arrays that do not fit the first image's MB count are
    refused before the native pack reads them."""
    c, seg, is_i4, qmat = (list(a) for a in _case("2x(1x5)"))
    cut = {"coeffs": c, "seg": seg, "is_i4": is_i4, "qmat": qmat}[bad]
    for b in range(1 if bad == "coeffs" else 0, len(cut)):
        cut[b] = cut[b][:-1]
    with pytest.raises(ValueError, match="pack"):
        ppack.pack_images(c, seg, is_i4, qmat)


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


# --- the kernel's contract: tables in block order, and its CTA spans ---

from gowebp_tpu_torch.ops.kernels import coeff_unpack as cum  # noqa: E402

_CU = (Path(cum.__file__).parent / "coeff_unpack.cu").read_text()


def _cu_int(name):
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def _in_order(idx, nblocks):
    return cum.in_block_order(torch.from_numpy(np.asarray(idx, np.int32)),
                              nblocks)


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_packs_emit_tables_in_block_order(monkeypatch, name, K):
    """The native pack (image by image, ``pack_images``), its numpy
    version and the reference's padded tables, across image boundaries:
    every table in block order under the wrapped key."""
    _force_k(monkeypatch, K)
    c = _case(name)
    nblocks = c[0].shape[0] * c[0].shape[1] * 24
    ours, _ = ppack.pack_coeffs(*c)
    images, _ = ppack.pack_images(*(list(a) for a in c))
    plain, _ = ppack.pack_coeffs_plain(*c)
    ref, _, _ = jpack.pack_coeffs(*c)
    for packed in (ours, images, plain, ref):
        for key in ("tail_idx", "exc_idx"):
            assert _in_order(packed[key], nblocks), key
    assert len(ref["tail_idx"]) > len(ours["tail_idx"])   # padded
    np.testing.assert_array_equal(images["tail_idx"], ours["tail_idx"])


@pytest.mark.parametrize("quality", [5, 75, 100])
def test_pack_of_real_symbols_in_block_order(quality):
    """The decode's pack of a group (``_pack_group``: one image at a time)
    on files of the JAX encoder keeps both tables in block order."""
    from gowebp_tpu_torch.decode import _pack_group

    rng = np.random.default_rng(quality + 1)
    datas = [gowebp_tpu.encode_rgba(
        rng.integers(0, 256, (33, 47, 3)).astype(np.uint8), quality=quality)
        for _ in range(3)]
    recs = _chip_smoke().decode_recs(datas)
    packed, _ = _pack_group(recs)
    nblocks = 3 * recs[0][2].shape[0] * 24
    assert _in_order(packed["tail_idx"], nblocks)
    assert _in_order(packed["exc_idx"], nblocks)


@pytest.mark.parametrize("idx,ok", [
    ([], True), ([5], True), ([0, 1, 2, 23], True), ([0, 23, 24, 24], True),
    ([0, -1], True), ([3, -20, 24, -25, 99], True), ([0, 0], False),
    ([2, 1], False), ([0, 24, 5], False), ([-1, 5], False),
    ([3, -25, 4], False)])
def test_in_block_order_accepts_and_rejects(idx, ok):
    """24 blocks: keys strictly increasing (negative indices from the
    end), dropped rows (24, -25, 99) only after every valid one."""
    assert _in_order(idx, 24) is ok


def _lower_bound(keys, x):
    """coeff_unpack.cu lower_bound: 32 probes cut [lo, hi) into 33."""
    lo, hi = 0, len(keys)
    while lo < hi:
        n = hi - lo
        ge = keys[lo + n * np.arange(1, 33) // 33] >= x
        f = int(np.argmax(ge)) if ge.any() else 32
        lo, hi = (lo + n * f // 33 + 1 if f > 0 else lo,
                  lo + n * (f + 1) // 33 if f < 32 else hi)
    return lo


def _keys(idx, nblocks):
    k = cum._wrapped(torch.from_numpy(np.asarray(idx, np.int32)), nblocks)
    return np.where(k.numpy() < 0, nblocks, k.numpy())


def _kernel_model(packed, base=0):
    """The kernel's rows as coeff_unpack.cu finds them, in numpy: each CTA
    of kThreads x kPer blocks searches its spans, checks them, and stages
    its tail levels from the 16-byte boundary below the span (``base``:
    the tail table's address mod 16) → the coefficients, or None where
    the kernel traps."""
    lv8 = np.asarray(packed["lv8"])
    B, N, _, K = lv8.shape
    nb, R, tw = B * N * 24, _cu_int("kThreads") * _cu_int("kPer"), 16 - K
    tk = _keys(packed["tail_idx"], nb) if K < 16 else np.zeros(0, np.int64)
    ek = _keys(packed["exc_idx"], nb)
    if (tk[_lower_bound(tk, nb):] != nb).any() or \
            (ek[_lower_bound(ek, nb):] != nb).any():
        return None
    lv = np.zeros((nb, 16), np.int64)
    lv[:, :K] = lv8.reshape(nb, K)
    mem = np.zeros(base + max(1, tk.size * tw) + 32, np.int8)
    if K < 16:
        mem[base:base + tk.size * tw] = np.asarray(
            packed["tail_val"]).reshape(-1)
    exc = np.full(nb, -1)
    for g0 in range(0, nb, R):
        g1 = min(g0 + R, nb)
        spans = []
        for keys in (tk, ek):
            s0, s1 = _lower_bound(keys, g0), _lower_bound(keys, g1)
            if s1 < s0 or s1 - s0 > g1 - g0:
                return None
            k = keys[s0:s1]
            if ((k < g0) | (k >= g1)).any() or (np.diff(k) <= 0).any():
                return None
            spans.append((s0, s1, k))
        (t0, t1, k), (e0, _, ke) = spans
        if t1 > t0:
            a = base + t0 * tw
            off = a % 16
            n16 = -(-(off + (t1 - t0) * tw) // 16)
            assert n16 * 16 <= R * tw + 16              # s_tv's size
            stage = mem[a - off:a - off + n16 * 16]
            for s, g in enumerate(k):
                lv[g, K:] = stage[off + s * tw:off + (s + 1) * tw]
        exc[ke] = e0 + np.arange(len(ke))
    seg = np.asarray(packed["seg"]).astype(np.int64)
    seg = np.where(seg < 4, seg, 0)
    rows = np.asarray(packed["qmat"]).astype(np.int64)[
        np.arange(B)[:, None], seg].reshape(B * N, 6)
    luma = np.tile(np.arange(24) < 16, B * N)
    mb = np.arange(nb) // 24
    q_dc = np.where(luma, rows[mb, 0], rows[mb, 4])
    q_ac = np.where(luma, rows[mb, 1], rows[mb, 5])
    zz = lv * np.where(np.arange(16) == 0, q_dc[:, None], q_ac[:, None])
    i16 = luma & (np.asarray(packed["is_i4"]).reshape(-1)[mb] == 0)
    dc = np.asarray(packed["dc16"]).reshape(B * N, 16)
    zz[i16, 0] = dc[mb[i16], np.arange(nb)[i16] % 24]
    has = exc >= 0
    zz[has] = np.asarray(packed["exc_val"])[exc[has]]
    out = np.empty_like(zz)
    out[:, list(cum.ZIGZAG)] = zz
    return out.astype(np.int16).reshape(B, N, 24, 16)


def _plain(packed):
    return unpack_coeffs_plain({k: torch.from_numpy(np.asarray(v))
                                for k, v in packed.items()}).numpy()


def test_kernel_model_constants_match_the_source():
    assert cum.BLOCKS_PER_CTA == _cu_int("kThreads") * _cu_int("kPer")
    assert "s_tv[K < 16 ? kRange * TW + 16 : 16]" in _CU
    assert len(_chip_smoke().UNPACK_CASES) == 7     # test_torch_cuda.py's


@pytest.mark.parametrize("base", [0, 4, 13])
@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("case", range(7))
def test_kernel_model_table_cases(case, K, base):
    """chip_smoke.UNPACK_CASES (the card tests' and phase 3i's tables at
    the CTA edges) through the kernel's spans, staged from a table 0, 4
    or 13 bytes past a 16-byte boundary: == the plain version."""
    cs = _chip_smoke()
    kind, B, N = cs.UNPACK_CASES[case]
    packed = cs.unpack_case(kind, K, B, N, case)
    assert _in_order(packed["tail_idx"], B * N * 24)
    np.testing.assert_array_equal(_kernel_model(packed, base), _plain(packed))


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_packs(monkeypatch, name, K):
    """The port's pack and the reference's padded one through the kernel's
    spans: the dense coefficients."""
    _force_k(monkeypatch, K)
    c = _case(name)
    for packed in (ppack.pack_coeffs(*c)[0], jpack.pack_coeffs(*c)[0]):
        np.testing.assert_array_equal(_kernel_model(packed, 12), c[0])


def _disorder(packed, how, nblocks):
    p = {k: np.array(v) for k, v in packed.items()}
    t, e = p["tail_idx"], p["exc_idx"]
    if how == "swap_adjacent":
        t[[3, 4]] = t[[4, 3]]
    elif how == "swap_far":
        t[[0, -1]] = t[[-1, 0]]
    elif how == "duplicate":
        t[5] = t[4]
    elif how == "dropped_then_valid":
        t[-2] = nblocks
    elif how == "negative_early":
        t[0] = -1
    elif how == "shuffled":
        np.random.default_rng(0).shuffle(t)
    elif how == "exc_swapped":
        e[[1, 2]] = e[[2, 1]]
    elif how == "exc_duplicate":
        e[-1] = e[-2]
    return p


@pytest.mark.parametrize("how", ["swap_adjacent", "swap_far", "duplicate",
                                 "dropped_then_valid", "negative_early",
                                 "shuffled", "exc_swapped",
                                 "exc_duplicate"])
def test_kernel_model_traps_on_tables_out_of_order(how):
    """Any table out of block order makes some CTA trap (the kernel's
    checks), never a silent result; the same tables in order do not."""
    cs = _chip_smoke()
    B, N = 3, 64
    packed = cs.unpack_case("random", 4, B, N, 1)
    bad = _disorder(packed, how, B * N * 24)
    key = "exc_idx" if how.startswith("exc") else "tail_idx"
    assert not _in_order(bad[key], B * N * 24)
    assert _kernel_model(bad) is None
    assert _kernel_model(packed) is not None


@pytest.mark.parametrize("seed", range(4))
def test_lower_bound_finds_the_first_key_at_or_above(seed):
    """On sorted keys it is numpy's searchsorted; on any keys it keeps
    key[t - 1] < x <= key[t], the invariant the kernel's checks rest on."""
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 32, 33, 34, 1000, 40000):
        keys = np.sort(rng.integers(0, 50000, n))
        mixed = rng.integers(0, 50000, n)
        for x in (0, 1, 25000, 49999, 50000, *rng.integers(0, 50000, 8)):
            assert _lower_bound(keys, x) == np.searchsorted(keys, x)
            t = _lower_bound(mixed, x)
            assert t == 0 or mixed[t - 1] < x
            assert t == n or mixed[t] >= x
