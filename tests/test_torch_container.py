"""PyTorch port: the container layer (riff, demux, mux) against the JAX
package's, byte for byte and field for field, on Pillow files and files
the reference muxes."""

import dataclasses
import io
import itertools

import numpy as np
import pytest
from PIL import Image

from gowebp_tpu.container import demux as ref_demux
from gowebp_tpu.container import mux as ref_mux
from gowebp_tpu.container import riff as ref_riff
from gowebp_tpu_torch.container import demux as port_demux
from gowebp_tpu_torch.container import mux as port_mux
from gowebp_tpu_torch.container import riff as port_riff

from util import make_test_images, pil_encode_lossless, pil_encode_lossy

IMAGES = make_test_images()
FLAGS = ("has_alpha", "has_animation", "has_icc", "has_exif", "has_xmp")


def _frames(n=3, size=(24, 32), alpha=False, seed=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = rng.integers(0, 256, size + (4,), dtype=np.uint8)
        f[..., 0] = 40 * i + 20
        f[..., 3] = rng.integers(0, 256, size) if alpha else 255
        out.append(f)
    return out


def _pil_animation(frames, durations, loop=2, **kw):
    imgs = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    imgs[0].save(buf, "WEBP", save_all=True, append_images=imgs[1:],
                 duration=durations, loop=loop, **kw)
    return buf.getvalue()


def _pil_still(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _fields(d):
    """A Demuxer's fields as plain data (frames as dicts, chunks as
    tuples), comparable across the two packages."""
    out = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
    out["frames"] = [dataclasses.asdict(f) for f in d.frames]
    out["unknown_chunks"] = [(c.tag, c.payload, c.truncated)
                             for c in d.unknown_chunks]
    out["num_frames"] = d.num_frames
    return out


def _outcome(fn):
    """("ok", result) or ("raise", the exception's class name): the two
    packages' error classes are their own, of the same names."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return "raise", type(e).__name__


def _same_outcome(ref_fn, port_fn):
    """Both calls give equal results, or raise the same exception class;
    the result, or None."""
    want = _outcome(ref_fn)
    assert _outcome(port_fn) == want
    return want[1] if want[0] == "ok" else None


# ---------------------------------------------------------------------------
# riff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=5)))
def test_build_vp8x_every_flag_combination(flags):
    kw = dict(zip(FLAGS, flags))
    for w, h in ((1, 1), (1920, 1080), (1 << 24, 3)):
        assert (port_riff.build_vp8x(w, h, **kw).serialize()
                == ref_riff.build_vp8x(w, h, **kw).serialize())


def test_build_vp8x_alpha_only_call_is_unchanged():
    """The port's existing callers pass has_alpha alone: same bytes."""
    for a in (False, True):
        assert (port_riff.build_vp8x(33, 17, has_alpha=a).payload
                == ref_riff.build_vp8x(33, 17, has_alpha=a).payload)


@pytest.mark.parametrize("bg,loop", [(0xFFFFFFFF, 0), (0, 1), (0x80FF0000, 7),
                                     (0x12345678, 65535)])
def test_build_anim_chunk(bg, loop):
    assert (port_riff.build_anim_chunk(bg, loop).serialize()
            == ref_riff.build_anim_chunk(bg, loop).serialize())
    assert (port_riff.build_anim_chunk().serialize()
            == ref_riff.build_anim_chunk().serialize())


@pytest.mark.parametrize("args,kw", [
    ((0, 0, 1, 1, 0), {}),
    ((2, 4, 33, 17, 100), {"dispose_background": True}),
    ((1024, 2, 256, 256, 16777215), {"no_blend": True}),
    ((16, 32, 1 << 24, 5, 40), {"dispose_background": True,
                                "no_blend": True}),
])
def test_build_anmf_header(args, kw):
    got = port_riff.build_anmf_header(*args, **kw)
    assert got == ref_riff.build_anmf_header(*args, **kw)
    assert len(got) == port_riff.ANMF_CHUNK_SIZE


@pytest.mark.parametrize("x,y", [(1, 0), (0, 3), (5, 7)])
def test_build_anmf_header_odd_offset_raises(x, y):
    for mod in (ref_riff, port_riff):
        with pytest.raises(ValueError):
            mod.build_anmf_header(x, y, 8, 8, 10)


def test_find_all_and_chunk_sizes():
    data = _pil_animation(_frames(3), [10, 20, 30])
    ref_p, port_p = ref_riff.parse_riff(data), port_riff.parse_riff(data)
    for tag in (b"ANMF", b"ANIM", b"VP8X", b"VP8L", b"EXIF"):
        assert ([c.payload for c in port_p.find_all(tag)]
                == [c.payload for c in ref_p.find_all(tag)])
    assert len(port_p.find_all(b"ANMF")) == 3
    assert port_riff.ANIM_CHUNK_SIZE == ref_riff.ANIM_CHUNK_SIZE
    assert port_riff.ANMF_CHUNK_SIZE == ref_riff.ANMF_CHUNK_SIZE


# ---------------------------------------------------------------------------
# demux
# ---------------------------------------------------------------------------


def _demux_files():
    """name -> file: Pillow animations and stills, and files with
    metadata and unknown chunks."""
    frames = _frames(3)
    alpha = _frames(3, alpha=True, seed=9)
    photo = IMAGES["photo"][..., :3].copy()
    files = {
        "anim_lossless": _pil_animation(frames, [100, 200, 300],
                                        lossless=True, exact=True),
        "anim_lossy": _pil_animation(frames, [40, 40, 80], quality=70),
        "anim_lossy_alpha": _pil_animation(alpha, [50, 60, 70], loop=0,
                                           quality=80),
        "anim_mixed_sizes": _pil_animation(
            [IMAGES["gradient"], IMAGES["gradient"][::-1].copy(),
             np.ascontiguousarray(IMAGES["gradient"][:, ::-1])],
            [30, 30, 30], lossless=True),
        "still_lossless": pil_encode_lossless(IMAGES["gradient"]),
        "still_lossless_alpha": pil_encode_lossless(IMAGES["alpha_noise"]),
        "still_lossy": pil_encode_lossy(photo),
        "still_lossy_alph": pil_encode_lossy(IMAGES["alpha_noise"]),
        "still_icc_exif_xmp": _pil_still(photo, quality=60,
                                         icc_profile=b"\x00" * 40,
                                         exif=b"Exif\x00\x00abc",
                                         xmp=b"<x:xmpmeta/>"),
        "anim_icc_exif_xmp": _pil_animation(frames, [10, 10, 10],
                                            lossless=True,
                                            icc_profile=b"\x01" * 33,
                                            exif=b"Exif\x00\x00xy",
                                            xmp=b"<xmp>1</xmp>"),
    }
    m = ref_mux.Mux.from_bytes(files["anim_lossless"])
    m.set_chunk("ABCD", b"custom-payload")
    m.set_chunk(b"WXYZ", b"odd")
    files["anim_unknown_chunks"] = m.assemble()
    m = ref_mux.Mux.from_bytes(files["still_lossy_alph"])
    m.set_chunk("QQQQ", b"")
    files["still_unknown_chunk"] = m.assemble()
    return files


FILES = _demux_files()


@pytest.mark.parametrize("name", sorted(FILES))
def test_demux_fields_equal_the_reference(name):
    data = FILES[name]
    want = _fields(ref_demux.demux(data))
    assert _fields(port_demux.demux(data)) == want
    assert _fields(port_demux.demux(data, partial=True)) == _fields(
        ref_demux.demux(data, partial=True))
    assert want["num_frames"] >= 1


def test_demux_reads_metadata_and_unknown_chunks():
    d = port_demux.demux(FILES["anim_icc_exif_xmp"])
    assert (d.iccp, d.exif, d.xmp) == (b"\x01" * 33, b"Exif\x00\x00xy",
                                       b"<xmp>1</xmp>")
    d = port_demux.demux(FILES["anim_unknown_chunks"])
    assert [(c.tag, c.payload) for c in d.unknown_chunks] == [
        (b"ABCD", b"custom-payload"), (b"WXYZ", b"odd")]
    d = port_demux.demux(FILES["still_lossy_alph"])
    assert d.num_frames == 1 and d.frames[0].alpha_payload is not None


@pytest.mark.parametrize("name", ["anim_lossless", "anim_lossy_alpha",
                                  "still_lossy_alph"])
def test_demux_at_every_truncation(name):
    """Every prefix of the file, with and without ``partial``: the same
    frames and ``is_partial``, or the same exception class."""
    data = FILES[name]
    partial_frames = set()
    for cut in range(len(data) + 1):
        prefix = data[:cut]
        for partial in (True, False):
            got = _same_outcome(
                lambda: _fields(ref_demux.demux(prefix, partial=partial)),
                lambda: _fields(port_demux.demux(prefix, partial=partial)))
            if partial and got is not None and got["is_partial"]:
                partial_frames.add(got["num_frames"])
    # the cuts covered the frames: cut before each frame ends
    assert len(partial_frames) == port_demux.demux(data).num_frames


@pytest.mark.parametrize("data", [b"", b"RIFF", b"RIFFxxxxJUNK" + b"\0" * 40,
                                  b"RIFF\x04\x00\x00\x00WEBP",
                                  b"RIFF\x0c\x00\x00\x00WEBPANMF\x04\x00\x00"
                                  b"\x00abcd"])
def test_demux_bad_files_raise_the_same_class(data):
    for partial in (False, True):
        _same_outcome(lambda: _fields(ref_demux.demux(data, partial=partial)),
                      lambda: _fields(port_demux.demux(data,
                                                       partial=partial)))


# ---------------------------------------------------------------------------
# mux
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FILES))
def test_mux_from_bytes_assemble_equals_the_reference(name):
    data = FILES[name]
    got = port_mux.Mux.from_bytes(data).assemble()
    assert got == ref_mux.Mux.from_bytes(data).assemble()
    # a file the muxer wrote round-trips exactly
    assert port_mux.Mux.from_bytes(got).assemble() == got


def _payloads(data):
    p = ref_riff.parse_riff(data)
    vp8l, vp8, alph = p.find(b"VP8L"), p.find(b"VP8 "), p.find(b"ALPH")
    return ((vp8l or vp8).payload, vp8l is not None,
            alph.payload if alph else None)


def _edits(mod):
    """One Mux built and edited through every call, in either package."""
    lossless = _payloads(pil_encode_lossless(IMAGES["solid"]))
    lossy_alpha = _payloads(pil_encode_lossy(IMAGES["alpha_noise"]))
    lossy = _payloads(pil_encode_lossy(IMAGES["photo"][..., :3].copy()))
    outs = []
    m = mod.Mux()
    m.set_image(*lossless)
    outs.append(m.assemble())
    m.set_image(*lossy_alpha)
    outs.append(m.assemble())
    m.set_chunk("ICCP", b"icc")
    m.set_chunk(b"EXIF", b"exif")
    m.set_chunk("XMP ", b"xmp")
    outs.append(m.assemble())
    m.push_frame(mod.MuxFrame(*lossy, x=4, y=6, duration_ms=70,
                              dispose_background=True))
    m.push_frame(mod.MuxFrame(*lossless, x=100, y=2, blend=False))
    m.set_animation_params(background_color=-1, loop_count=9)
    outs.append(m.assemble())
    m.set_canvas_size(300, 200)
    m.set_chunk("ABCD", b"1")
    m.set_chunk("ABCD", b"22")
    outs.append(m.assemble())
    assert m.get_chunk("ABCD") == b"22" and m.get_chunk(b"EXIF") == b"exif"
    assert m.get_chunk("NONE") is None
    m.delete_chunk("EXIF")
    m.delete_chunk(b"ABCD")
    m.delete_frame(0)
    outs.append(m.assemble())
    m.delete_frame(-1)
    m.iccp = m.xmp = None
    outs.append(m.assemble())
    m.set_canvas_size(0, 0)
    outs.append(m.assemble())
    return outs


def test_mux_edits_give_the_reference_bytes():
    got, want = _edits(port_mux), _edits(ref_mux)
    assert got == want
    # the single-frame collapse: the last file is a still image
    d = port_demux.demux(got[-1])
    assert d.num_frames == 1 and not d.has_animation


def test_mux_frame_dims_and_alpha():
    for data in (FILES["still_lossless_alpha"], FILES["still_lossy_alph"],
                 FILES["still_lossy"]):
        args = _payloads(data)
        f, g = port_mux.MuxFrame(*args), ref_mux.MuxFrame(*args)
        assert (f.dims(), f.has_alpha()) == (g.dims(), g.has_alpha())


@pytest.mark.parametrize("case", [
    "fourcc_short", "fourcc_long", "image_tag", "alpha_tag", "anim_tag",
    "anmf_tag", "vp8l_tag", "canvas_negative", "canvas_huge",
    "canvas_too_small", "loop_negative", "loop_too_big", "empty_assemble",
    "bad_frame_payload"])
def test_mux_errors_raise_the_reference_class(case):
    data = FILES["anim_lossless"]

    def run(mod):
        m = mod.Mux.from_bytes(data)
        {
            "fourcc_short": lambda: m.set_chunk("ABC", b""),
            "fourcc_long": lambda: m.set_chunk(b"ABCDE", b""),
            "image_tag": lambda: m.set_chunk("VP8 ", b""),
            "alpha_tag": lambda: m.set_chunk("ALPH", b""),
            "anim_tag": lambda: m.set_chunk(b"ANIM", b""),
            "anmf_tag": lambda: m.set_chunk("ANMF", b""),
            "vp8l_tag": lambda: m.set_chunk("VP8L", b""),
            "canvas_negative": lambda: m.set_canvas_size(-1, 10),
            "canvas_huge": lambda: m.set_canvas_size(10, (1 << 24) + 1),
            "canvas_too_small": lambda: m.set_canvas_size(8, 8),
            "loop_negative": lambda: m.set_animation_params(loop_count=-1),
            "loop_too_big": lambda: m.set_animation_params(
                loop_count=1 << 16),
            "empty_assemble": lambda: mod.Mux().assemble(),
            "bad_frame_payload": lambda: (
                m.push_frame(mod.MuxFrame(b"junk", False)), m.assemble()),
        }[case]()

    kind, name = _outcome(lambda: run(ref_mux))
    assert kind == "raise"
    assert _outcome(lambda: run(port_mux)) == (kind, name)
