"""How ``correct`` is decided: the outputs that the window's calls produced
(every one of an encode; of a decode, one of every pool file and then a
few a call, as generator.run_window keeps them) held against the plain
reference in vp8ref/ (which imports nothing of the program).  Every pool
item has to have an output held.  The reference runs in a few worker
processes (refpool.py) once the window has closed.

Encode: every distinct file the window wrote for an image is parsed and
decoded by the reference.  A file counts as bad where the reference refuses
it or its frame header departs from the configuration's settings.  Then,
macroblock by macroblock on the source image, the reference re-derives the
levels a closed-loop encoder with the port's quantizer has to code for the
file's own modes, segments and quantizers, each block predicted from the
decoded picture, and counts the blocks whose coded levels differ.  That
holds the dense engine's levels and reconstruction, the pack, the d2h and
the host emission; the mode decisions themselves are only held to being
coded consistently.

Decode: every kept output is compared, byte for byte, with the reference's
RGBA decode of the same file (libwebp's default: loop filter, fancy
upsampling).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from . import refpool
from .bench import log


def quality_to_q(quality: float) -> int:
    """The quantizer index a quality asks for (libwebp's power law, rounded
    as the port rounds it)."""
    c = quality / 100.0
    linear = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
    return int(127.0 * (1.0 - linear ** (1.0 / 3.0)) + 0.5)


def header_faults(fr, settings: dict, h: int, w: int) -> list:
    out = []
    if (fr.width, fr.height) != (w, h):
        out.append(f"size {fr.width}x{fr.height}")
    if fr.partitions != 1 << settings["partitions"]:
        out.append(f"{fr.partitions} token partitions")
    if fr.simple != int(settings["filter_type"] == 0):
        out.append("loop filter type")
    if fr.sharpness != settings["filter_sharpness"]:
        out.append(f"sharpness {fr.sharpness}")
    if (fr.level > 0) != (settings["filter_strength"] > 0):
        out.append(f"filter level {fr.level}")
    used = np.unique(fr.segment)
    q = fr.quant_index[used]
    want = quality_to_q(settings["quality"])
    if not q.min() <= want <= q.max():
        out.append(f"quantizers {q.tolist()} leave out {want}")
    return out


def _levels_job(data: bytes, rgb, settings: dict, diffusion: bool):
    """(header faults, differing blocks, blocks) of one encoded file, or
    (the reference's refusal, 0, 0)."""
    from .vp8ref import check_levels

    try:
        fr, m, b = check_levels(data, rgb, diffusion=diffusion)
    except Exception as e:              # the reference refuses the file
        return [repr(e)], 0, 0
    h, w = rgb.shape[:2]
    return header_faults(fr, settings, h, w), m, b


def _decode_job(data: bytes):
    """(RGBA, the decode's work) of one file by the reference."""
    from .vp8ref import decode_rgba

    work = {}
    return decode_rgba(data, work=work), work


TASKS = {"levels": _levels_job, "decode": _decode_job}


def check_encode(config: dict, images, kept: list) -> dict:
    """{"bad_files", "level_mismatch_blocks"} over the kept outputs."""
    settings = config["settings"]
    diffusion = config["held_to"]["uv_dc_error_diffusion"]
    distinct = Counter((i, bytes(data or b"")) for i, data in kept)
    bad = sum(1 for i in range(len(images))
              if i not in {i for i, _ in distinct})
    if bad:
        log(f"encode check: {bad} pool images have no output")
    jobs = [(data, images[i], settings, diffusion) for i, data in distinct]
    mismatch = 0
    for ((i, data), n), (faults, m, b) in zip(
            distinct.items(), refpool.run("levels", jobs)):
        if faults:
            log(f"encode check: image {i}: {', '.join(faults)}")
            bad += n
        mismatch += m * n
        log(f"encode check: image {i}: {len(data)} bytes, {n} outputs, "
            f"{m} of {b} blocks differ")
    return {"bad_files": bad, "level_mismatch_blocks": mismatch}


def to_host(out) -> np.ndarray:
    if hasattr(out, "detach"):
        return out.detach().to("cpu").numpy()
    return np.asarray(out)


def reference_decodes(files: list) -> tuple:
    """([RGBA], [work]) of every file by the reference."""
    done = refpool.run("decode", [(f,) for f in files]) if files else []
    return [r for r, _ in done], [w for _, w in done]


def check_decode(refs: list, kept: list) -> dict:
    """{"missing_outputs", "pixel_mismatch"} of the kept outputs against
    ``refs``, the reference's RGBA of every pool file."""
    missing = sum(1 for i in range(len(refs))
                  if i not in {k for k, _ in kept})
    mismatch = 0
    for i, out in kept:
        want = refs[i]
        got = to_host(out) if out is not None else None
        if got is None or got.shape != want.shape or got.dtype != want.dtype:
            log(f"decode check: file {i}: output "
                f"{None if got is None else (got.shape, got.dtype)}")
            mismatch += want.size
            continue
        m = int((got != want).sum())
        mismatch += m
        if m:
            log(f"decode check: file {i}: {m} bytes differ")
    log(f"decode check: {len(kept)} outputs of {len(refs)} files compared")
    return {"missing_outputs": missing, "pixel_mismatch": mismatch}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
