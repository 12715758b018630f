"""PyTorch port, the incremental decoder (``IncrementalDecoder``) on
``device="cpu"`` against the JAX package's, bit for bit and exception
class for exception class.

The files: a Pillow q75 lossy photo (tests/test_decode_options.py's
LOSSY), a lossy + ALPH file and a VP8L file from the JAX encoder, Pillow
VP8L files (the gradient of test_decode_options.py and a 120x90 noise
image).  After every append, at chunk sizes 1, 37, 500 and seeded random
ones, the two decoders are in the same state, and the port's partial
output is the final decode's first rows (partial lossy rows are
reconstructed by the port's decode kernels' plain versions; alpha 255).

A VP8L stream resumes exactly in both packages: rows and partial output
equal the reference's after every append.  A lossy stream differs where
the reference is wrong: its decoder commits a macroblock whose tokens
read up to 4 bytes past what has arrived (zeros in the boolean decoder's
window), and builds a token partition's decoder on fewer bytes than its
window loads, so its partial rows can differ from its own final decode
(``test_reference_partial_rows_can_differ_from_final``).  The port
commits an MB only on bytes that have arrived: its rows after any
chunking equal those of a decoder given the same bytes at once, and on
one append of a prefix they are a prefix of the reference's, equal to
them wherever the reference's equal the final rows.
"""

import numpy as np
import pytest
import torch

import gowebp_tpu
import gowebp_tpu_torch
from gowebp_tpu.idec import IncrementalDecoder as JDecoder
from gowebp_tpu_torch import decode_rgba
from gowebp_tpu_torch.errors import NotEnoughData
from gowebp_tpu_torch.idec import (STATE_DATA, STATE_DONE, STATE_HEADER,
                                   IncrementalDecoder)

from util import (make_test_images, pil_decode_rgba, pil_encode_lossless,
                  pil_encode_lossy)

IMAGES = make_test_images()
LOSSY = pil_encode_lossy(IMAGES["photo"][..., :3].copy(), quality=75)
LOSSLESS = pil_encode_lossless(IMAGES["gradient"])


def _image(h, w, seed, alpha):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([120 + 60 * np.sin(xx / 5), 110 + 50 * np.cos(yy / 4),
                    (3 * xx + 2 * yy) % 256], -1)
    rgb = (rgb + rng.normal(0, 12, rgb.shape)).clip(0, 255).astype(np.uint8)
    if not alpha:
        return rgb
    a = 255 * xx / max(w - 1, 1) + rng.integers(-30, 30, (h, w))
    a[: h // 3, : w // 3] = 0
    return np.dstack([rgb, a.clip(0, 255).astype(np.uint8)])


_FILES = {}


def _file(kind):
    if kind not in _FILES:
        if kind == "lossy":
            _FILES[kind] = LOSSY
        elif kind == "alph":
            _FILES[kind] = gowebp_tpu.encode_rgba(
                _image(96, 56, 3, alpha=True), quality=70)
        elif kind == "vp8l":
            _FILES[kind] = gowebp_tpu.encode_rgba(
                _image(37, 29, 4, alpha=True), lossless=True)
        else:
            rng = np.random.default_rng(9)
            arr = rng.integers(0, 255, (120, 90, 4), dtype=np.uint8)
            arr[..., 3] = 255
            _FILES[kind] = pil_encode_lossless(arr)
    return _FILES[kind]


def _steps(n, chunk):
    """Chunk boundaries: a fixed size, or seeded random sizes of 1-300."""
    if chunk != "random":
        return list(range(0, n, chunk)) + [n]
    rng = np.random.default_rng(n)
    cuts = np.cumsum(rng.integers(1, 300, n))
    return [0] + [int(c) for c in cuts[cuts < n]] + [n]


def _same_partial(a, b):
    pa, pb = a.get_partial_output(), b.get_partial_output()
    assert (pa is None) == (pb is None)
    if pa is not None:
        assert pa.dtype == pb.dtype == np.uint8
        np.testing.assert_array_equal(pa, np.asarray(pb))
    return pa


def _final(data):
    full = decode_rgba(data, device="cpu")
    np.testing.assert_array_equal(full, gowebp_tpu.decode_rgba(data))
    return full


@pytest.mark.parametrize("chunk", [1, 37, 500, "random"])
@pytest.mark.parametrize("kind", ["lossy", "alph", "vp8l"])
def test_after_every_append(kind, chunk):
    """The reference's state after every append; the port's partial
    output is the final rows whenever its rows move; its rows equal one
    append of the same prefix (checked as they move and every 16th
    append); a VP8L stream's rows and partial output are the
    reference's after every append."""
    data = _file(kind)
    full = _final(data)
    ours, ref = IncrementalDecoder(device="cpu"), JDecoder()
    seen = None
    cuts = _steps(len(data), chunk)
    for k, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
        assert ours.append(data[lo:hi]) == ref.append(data[lo:hi])
        assert ours.state == ref.state
        n = ours.rows_decoded
        if kind != "lossy":
            # VP8L resumes exactly in both; a VP8X (ALPH) file fed from its
            # first bytes never shows partial rows in either package (its
            # format is read from headers that hold no image chunk yet)
            assert n == ref.rows_decoded
        if (ours.state, n) != seen or k % 16 == 0:
            if ours.state != STATE_DONE and kind == "lossy":
                once = IncrementalDecoder(device="cpu")
                once.append(data[:hi])
                assert once.rows_decoded == n
            if (ours.state, n) != seen:
                part = (_same_partial(ours, ref) if kind == "vp8l"
                        else ours.get_partial_output())
                assert (part is None) == (n == 0)
                if part is not None:
                    np.testing.assert_array_equal(part, full[:n])
            seen = (ours.state, n)
    assert ours.state == STATE_DONE and ours.rows_decoded == full.shape[0]
    np.testing.assert_array_equal(ours.get_output(), full)
    np.testing.assert_array_equal(ours.get_output(),
                                  np.asarray(ref.get_output()))


@pytest.mark.parametrize("kind", ["lossy", "alph"])
def test_one_append_prefix_against_reference(kind):
    """One append of a prefix: the port's rows are at most the
    reference's, and its partial output is the first rows of the
    reference's wherever the reference's equal the final rows (RGB: the
    partial alpha is 255)."""
    data = _file(kind)
    full = _final(data)[..., :3]
    agreed = 0
    for cut in range(20, len(data), max(1, len(data) // 40)):
        ours, ref = IncrementalDecoder(device="cpu"), JDecoder()
        assert ours.append(data[:cut]) == ref.append(data[:cut])
        n, m = ours.rows_decoded, ref.rows_decoded
        assert n <= m
        pr = ref.get_partial_output()
        if m and np.array_equal(np.asarray(pr)[..., :3], full[:m]):
            part = ours.get_partial_output()
            if n:
                np.testing.assert_array_equal(part, np.asarray(pr)[:n])
                assert (part[..., 3] == 255).all()
                agreed += 1
    assert agreed > 0


def test_reference_partial_rows_can_differ_from_final():
    """The fault the port does not copy: LOSSY in 37-byte appends gives
    the reference partial rows that are not its final rows; the port's
    are."""
    full = _final(LOSSY)
    ours, ref = IncrementalDecoder(device="cpu"), JDecoder()
    ref_wrong = ours_rows = 0
    for i in range(0, len(LOSSY), 37):
        ours.append(LOSSY[i:i + 37])
        ref.append(LOSSY[i:i + 37])
        if ref.state != STATE_DONE and ref.rows_decoded:
            m = ref.rows_decoded
            ref_wrong += not np.array_equal(
                np.asarray(ref.get_partial_output()), full[:m])
        if ours.state != STATE_DONE and ours.rows_decoded:
            n = ours.rows_decoded
            np.testing.assert_array_equal(ours.get_partial_output(),
                                          full[:n])
            ours_rows = max(ours_rows, n)
    assert ref_wrong > 0 and ours_rows > 0


def test_alph_partial_rows_have_alpha_255():
    """The reference writes alpha 255 in an ALPH file's partial rows (the
    ALPH chunk is read only once the file is complete); the final output
    has the real alpha.  A VP8X file shows partial rows only where the
    first append already reaches its VP8 chunk (both packages take the
    format from the headers of the first bytes that parse)."""
    from gowebp_tpu_torch.container.riff import parse_riff

    data = _file("alph")
    vp8 = parse_riff(data).find(b"VP8 ")
    start = data.index(b"VP8 ") + 8
    ours, ref = IncrementalDecoder(device="cpu"), JDecoder()
    for lo, hi in ((0, start + len(vp8.payload) * 3 // 4),
                   (start + len(vp8.payload) * 3 // 4, len(data) - 1)):
        assert ours.append(data[lo:hi]) == ref.append(data[lo:hi])
        assert ours.rows_decoded > 0 and ref.rows_decoded > 0
        part, pref = ours.get_partial_output(), ref.get_partial_output()
        assert part.shape[0] == ours.rows_decoded
        assert (part[..., 3] == 255).all()
        assert (np.asarray(pref)[..., 3] == 255).all()
    full = decode_rgba(data, device="cpu")
    np.testing.assert_array_equal(part[..., :3], full[: part.shape[0], :, :3])
    assert (full[..., 3] != 255).any()
    assert ours.append(data[-1:]) == STATE_DONE
    np.testing.assert_array_equal(ours.get_output(), full)


def test_chunked_lossy():
    dec = IncrementalDecoder(device="cpu")
    step = max(1, len(LOSSY) // 17)
    saw_partial = False
    for i in range(0, len(LOSSY), step):
        dec.append(LOSSY[i : i + step])
        if dec.state != STATE_DONE and dec.rows_decoded > 0:
            part = dec.get_partial_output()
            assert part is not None
            saw_partial = True
    assert dec.state == STATE_DONE
    np.testing.assert_array_equal(dec.get_output(),
                                  decode_rgba(LOSSY, device="cpu"))
    np.testing.assert_array_equal(dec.get_output(),
                                  gowebp_tpu.decode_rgba(LOSSY))
    assert saw_partial


def test_partial_rows_match_final():
    dec = IncrementalDecoder(device="cpu")
    dec.append(LOSSY[: len(LOSSY) * 2 // 3])
    n = dec.rows_decoded
    assert n > 0
    part = dec.get_partial_output()
    full = decode_rgba(LOSSY, device="cpu")
    np.testing.assert_array_equal(part, full[:n])
    dec.append(LOSSY[len(LOSSY) * 2 // 3 :])
    assert dec.state == STATE_DONE


def test_mb_granular_resume():
    """The lossy decode resumes per macroblock, not per row: mid-row
    progress is observable under tiny appends, and the result stays
    bit-exact."""
    dec = IncrementalDecoder(device="cpu")
    saw_mid_row = False
    step = 37
    for i in range(0, len(LOSSY), step):
        dec.append(LOSSY[i : i + step])
        v = dec._vp8
        if v is not None and (v._modes_x > 0 or v._resid_x > 0):
            saw_mid_row = True
    assert dec.state == STATE_DONE
    np.testing.assert_array_equal(dec.get_output(),
                                  decode_rgba(LOSSY, device="cpu"))
    assert saw_mid_row, "decoder never held mid-row progress"


def test_chunked_lossless():
    dec = IncrementalDecoder(device="cpu")
    for i in range(0, len(LOSSLESS), 50):
        dec.append(LOSSLESS[i : i + 50])
    assert dec.state == STATE_DONE
    np.testing.assert_array_equal(dec.get_output(),
                                  decode_rgba(LOSSLESS, device="cpu"))
    np.testing.assert_array_equal(dec.get_output(), pil_decode_rgba(LOSSLESS))


def test_incomplete_raises():
    dec = IncrementalDecoder(device="cpu")
    assert dec.append(LOSSY[:100]) == STATE_DATA
    with pytest.raises(NotEnoughData):
        dec.get_output()
    assert IncrementalDecoder(device="cpu").append(LOSSY[:11]) == STATE_HEADER


def test_lossless_partial_rows():
    """VP8L suspend/resume: partial rows match the final decode."""
    data = _file("noise")
    full = decode_rgba(data, device="cpu")
    dec = IncrementalDecoder(device="cpu")
    saw_partial = 0
    for i in range(0, len(data), 37):
        dec.append(data[i : i + 37])
        n = dec.rows_decoded
        if dec.state != STATE_DONE and n > 0:
            part = dec.get_partial_output()
            np.testing.assert_array_equal(part[:n], full[:part.shape[0]][:n])
            saw_partial = max(saw_partial, n)
    assert dec.state == STATE_DONE
    np.testing.assert_array_equal(dec.get_output(), full)
    assert saw_partial > 0      # resumed mid-stream at least once


def _run(cls, data, chunk):
    """Feed ``data`` in chunks; (exception class or None, state, rows,
    partial output) at the end."""
    dec = cls() if cls is JDecoder else cls(device="cpu")
    try:
        for i in range(0, len(data), chunk):
            dec.append(data[i:i + chunk])
        part = dec.get_partial_output()
        if dec.state == STATE_DONE:
            dec.get_output()
        return None, dec.state, dec.rows_decoded, part
    except Exception as e:      # noqa: BLE001 (the class is compared)
        return type(e).__name__, None, None, None


@pytest.mark.parametrize("kind", ["lossy", "alph", "vp8l"])
def test_truncated_and_corrupted_streams(kind):
    """Truncations and byte flips (headers, partition sizes, token data,
    prefix codes), fed at once and in 29-byte chunks: the same exception
    class, or the same state, as the reference.  Fed at once, the rows
    and partial output too: equal for VP8L; for a lossy stream the port's
    rows at most the reference's and its partial output their first
    rows."""
    data = _file(kind)
    rng = np.random.default_rng(len(data))
    cases = [data[:n] for n in (5, 12, 20, 30, 40, len(data) // 2,
                                len(data) - 1)]
    for pos in sorted({*range(12, min(60, len(data)), 6),
                       *rng.integers(12, len(data), 8).tolist()}):
        for flip in (0x01, 0xFF):
            bad = bytearray(data)
            bad[pos] ^= flip
            cases.append(bytes(bad))
    cases.append(b"RIFF\xff\xff\x00\x00WEBPVP8X" + bytes(80))
    cases.append(b"not a webp file at all" * 4)
    for case in cases:
        for chunk in (len(case), 29):
            ours = _run(IncrementalDecoder, case, chunk)
            ref = _run(JDecoder, case, chunk)
            assert ours[:2] == ref[:2], (case[:16], chunk)
            if chunk != len(case) or ours[0] is not None:
                continue
            if kind == "vp8l" or ours[1] == STATE_DONE:
                assert ours[2] == ref[2]
                assert (ours[3] is None) == (ref[3] is None)
            else:
                assert ours[2] <= ref[2]
            if ours[3] is not None:
                np.testing.assert_array_equal(
                    ours[3], np.asarray(ref[3])[:ours[3].shape[0]])


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        IncrementalDecoder()
    with pytest.raises(RuntimeError):
        gowebp_tpu_torch.IncrementalDecoder(device="cuda")
    IncrementalDecoder(device="cpu")
