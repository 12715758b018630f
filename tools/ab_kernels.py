#!/usr/bin/env python3
"""Time the kernels of several checkouts in turns, on one card, on the same
inputs.

    python3 tools/ab_kernels.py --kernel KERNEL CHECKOUT [CHECKOUT ...]

e.g. ``python3 tools/ab_kernels.py --kernel encode_plane _archive/parent
. . _archive/parent`` (a parent unpacked with ``git archive`` under
``_archive/``, which ``.gitignore`` lists) for the order parent, change,
change, parent.

The inputs are made once in this process and saved; each checkout then
runs in a process of its own, which builds its own kernels from its own
sources (nvcc) and times its own wrappers with CUDA events.  Every run's
outputs must equal the first run's, bit for bit.  Prints one JSON line
per run, the card's name and power limit, and exits 1 on a mismatch.
Needs a CUDA card and nvcc.  KERNEL is one of:

``wavefront_search``
    The exact engine's chunk: the first 16 of ``natural_images(32, 1024,
    1024, seed=7)`` through the encode pipeline's own host steps at q75
    (``chip_smoke.chunk_inputs`` of this checkout).  Times (median of 5
    calls after a warm-up) B=16 at 1024x1024 with try_i4 and diffusion on
    (the exact engine's call; also ``b16_device_ms``, the device time of
    a launch as ``chip_smoke.py`` reports ``device_ms``), the
    try_i4=False form, and B=1 (one image: the chain of 190 MB steps).
    Where the checkout's ``wavefront_search`` takes ``lams=``, its
    trellis form too (``trellis_*``: B=16 one call and device time, B=1
    and us a chained step), on the rate tables of image 0's first-pass
    probabilities and the chunk's lambdas (``chip_smoke.first_pass_tables``
    and ``trellis_lambdas``, made once by this checkout).

``encode_plane``
    B=16 random 1024x1024 planes in one wire buffer
    (``chip_smoke.check_encode_plane``'s timed inputs) with the q75
    quantizers, and the hybrid's chunk as above.  Times ``encode_luma``
    and ``encode_chroma``, their modes-only forms where the checkout has
    them, and the hybrid's cold round (``openloop_mode_search(...,
    try_i4=False)`` on the chunk), each two ways: ``*_ms`` one call
    (median of 50 after a warm-up), the wrapper's host time included, as
    ``chip_smoke.py`` reports ``ms``; ``*_device_ms`` the device time of
    a launch (calls queued behind a sleeping stream, so the host's part
    of each call does not idle the card; the median of 5 means of 50
    calls, 4 for the cold round), as ``chip_smoke.py`` reports
    ``device_ms``.  Also the hybrid's stage spans on the chunk with the
    host quiet (``chip_smoke.stage_spans``, median of 10).

``encode_rgba``
    The single-image encode end to end: ``chip_smoke.py`` phase 8c's 1 MP
    image (corpus image 12 of ``natural_images(32, 1024, 1024, seed=7)``)
    as RGB through ``encode_rgba(device="cuda")`` at method 6 (the
    trellis form's path) and at the default method 4, and as RGBA with
    phase 8c's soft alpha at method 4 (the ALPH coder's path), each the
    median of 7 calls after a warm-up on the host clock (``rgb_m6_ms``,
    ``rgb_m4_ms``, ``rgba_m4_ms``); the files must be equal across runs.

``vp8l_predictor``
    The lossless encode's predictor chooser ``predictor_search_entropy``
    on ``chip_smoke.py`` phase 3h's timed inputs: the 1 MP subtract-green
    ARGB words of corpus image 12 of ``natural_images(32, 1024, 1024,
    seed=7)`` at bits 4 (the default encode's, ``b4_*``) and at bits 3
    and 5, and that image with phase 8c's soft alpha at bits 4
    (``alpha_b4_*``: no tile is opaque), with ``refine_iters`` 2.  Times
    each as one call (``*_ms``, median of 20 after a warm-up, the
    wrapper's host time and its syncs between passes included) and as
    the device time of the call's launches (``*_device_ms``: the passes
    replayed without their syncs by the checkout's own
    ``chip_smoke.chooser_replay``, queued behind a sleeping stream);
    stage 1 alone (``*_stage1_device_ms``) and a round
    (``*_round_device_ms``: the rest over the rounds).  Then the photo
    path's pair of choosers as the 1 MP RGB lossless encode runs them:
    ``models/vp8l/encoder.py`` ``_device_modes`` on the words with and
    without subtract-green, at bits 4, in two threads at once
    (``pair_wall_ms``: the median of 100 on the host clock, upload and
    download included).  The mode maps of every call, of stage 1 and of
    the pair must equal the first run's.

``decode``
    The batch decode end to end, as ``chip_smoke.py`` phases 6 and 6b
    run it: the 32 hybrid files of ``natural_images(32, 1024, 1024,
    seed=7)`` at q75 (encoded on the card by this checkout), and those
    files with phase 6b's 4 lossy + ALPH and 4 VP8L files from Pillow,
    through ``decode_rgba_batch(device="cuda")``: MP/s of the median of 5
    calls after a warm-up (host clock, pixels back in host memory;
    ``hybrid_mps``, ``mixed_mps``), and the stage split and h2d bytes of
    one more call (``*_timings``: the checkout's own ``timings``).  Every
    run's pixels must equal the first run's (SHA-256 of each image).

``unpack_coeffs``
    The batch decode's sparse coefficient unpack on ``chip_smoke.py``
    phase 3i's packed inputs, made once by this checkout's pack: the 32
    hybrid files of ``natural_images(32, 1024, 1024, seed=7)`` at q75
    (encoded on the card) packed at K = 4, 8 and 16 (``k4``, ``k8``,
    ``k16``), the K=4 pack without its tail rows (``k4_bare``: a tail
    row's cost is ``(k4 - k4_bare)`` over the rows), and 16 smooth q95
    files (``chip_smoke.smooth_images``) at their chosen K=4 (``q95``).
    Times each as one call (``*_ms``, median of 20 after a warm-up) and
    as the device time of a launch (``*_device_ms``, median of 5 means of
    50 queued calls); every run's coefficients must equal the first's.

``pack``
    The batch decode's coefficient pack alone, on the host: the 32 files
    of ``natural_images(32, 1024, 1024, seed=7)`` as libwebp (Pillow) made
    them at q75 method 4, as the benchmark's decode pool is made, through
    the checkout's own symbol engine (``chip_smoke.decode_recs``) once,
    then its ``decode._pack_group`` (``pack_images``).  Times the group
    on one thread (``one_thread_ms_per_file``: the median of 7 calls over
    32) and four groups on four threads at once, as the decode's symbol
    threads run them (``four_threads_ms_per_file``: the median of 5 walls
    over 32), and reports the chosen ``K``.  Every run's packed arrays
    must equal the first run's.  Nothing of it runs on the card.

``vp8_recon``
    The decode's recon and loop filter on the decode path's inputs for
    the 32 hybrid files of ``natural_images(32, 1024, 1024, seed=7)`` at
    q75 (encoded on the card by this checkout, then
    ``chip_smoke.recon_symbols``).  A checkout with ``recon_filter_mb``
    runs that one launch; an older one runs ``recon_mb`` then
    ``loop_filter_mb``.  Times B=32 at 1024x1024 as one call (``b32_ms``,
    median of 20 after a warm-up) and as the device time of a call
    (``b32_device_ms``), and B=1 (one image: the chain of 190 MB steps,
    ``b1_ms`` and ``us_per_chained_mb_step``); an older checkout also
    gives each of its two kernels' device times.

``vp8l_inverse``
    The sharded lossless inverse's ``predictor_inverse`` with the
    add-green epilogue, at bits 4, on ``chip_smoke.py`` phase 10's inputs
    (``chip_smoke.lossless_case``): the first 8 of ``natural_images(32,
    1024, 1024, seed=7)`` as subtract-green residuals of a random tile map
    (seed 19; ``b8_*``), the first of them alone (``b1_*``) and the 4x4
    mosaic of the first 16 as one 4096x4096 image (seed 20; ``big_*``).
    Times each as one call (``*_ms``, median of 20 after a warm-up) and as
    the device time of a launch (``*_device_ms``), with ``*_us_per_step``
    the device time over the chain's w + 2 (h - 1) steps.  Where the
    checkout's wrapper takes a CTA's warps (``vp8l_inverse.launch``), also
    B=8 at 1, 2, 4 and 8 warps a CTA (``b8_warps*_device_ms``).  Every
    run's pixels must equal the first run's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Run in each checkout: argv[1] the saved inputs, argv[2] where the
# outputs go (a dict of tensors); prints one JSON line of times.
COMMON = r"""
import json, statistics, subprocess, sys, time
sys.path.insert(0, ".")
import torch

def time_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

def queued_ms(fn, reps=50, rounds=5):
    # reps calls enqueued behind a sleeping stream run back to back: the
    # device time of a launch, without the host's part of each call (as
    # chip_smoke.queued_ms, which an older checkout's chip_smoke lacks)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    for _ in range(3):
        fn()
    torch.cuda._sleep(1000)
    sleep_ms, means = 20.0, []
    while len(means) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * mhz * 1e3))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms > 0.8 * sleep_ms:     # the host outlasted the sleep: redo
            sleep_ms = 2 * host_ms
            continue
        means.append(a.elapsed_time(b) / reps)
    return statistics.median(means)

saved = torch.load(sys.argv[1])
dev = torch.device("cuda:0")
"""

RUNS = {
    "wavefront_search": r"""
import inspect
from gowebp_tpu_torch.ops.kernels.wavefront_search import (LIBRARY,
                                                           wavefront_search)

LIBRARY.load()
args = tuple(t.to(dev) for t in saved["args"])
rate = tuple(t.to(dev) for t in saved["rate"])
run = lambda a, i4: wavefront_search(*a, rate, try_i4=i4, use_derr=True,
                                     want_recon=True)
out = run(args, True)
trellis = "lams" in inspect.signature(wavefront_search).parameters
if trellis:
    trate = tuple(t.to(dev) for t in saved["trellis_rate"])
    lams = saved["lams"].to(dev)
    run_t = lambda a, lam: wavefront_search(*a, trate, try_i4=True,
                                            use_derr=True, want_recon=True,
                                            lams=lam)
    out.update({"trellis_" + k: t for k, t in run_t(args, lams).items()})
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[2])
one = tuple(t[:1].contiguous() for t in args)
B, H, W = args[0].shape
steps = (W // 16 - 1) + 2 * (H // 16 - 1) + 1
b1 = time_ms(lambda: run(one, True), 5)
row = {"b16_ms": time_ms(lambda: run(args, True), 5),
       "b16_device_ms": queued_ms(lambda: run(args, True), reps=10),
       "lean_ms": time_ms(lambda: run(args, False), 5),
       "b1_ms": b1, "us_per_chained_mb_step": b1 / steps * 1e3,
       "i4_share": out["is_i4"].float().mean().item()}
if trellis:
    one_lams = lams[:1].contiguous()
    tb1 = time_ms(lambda: run_t(one, one_lams), 5)
    row.update({
        "trellis_b16_ms": time_ms(lambda: run_t(args, lams), 5),
        "trellis_b16_device_ms": queued_ms(lambda: run_t(args, lams),
                                           reps=10),
        "trellis_b1_ms": tb1,
        "trellis_us_per_chained_mb_step": tb1 / steps * 1e3})
print(json.dumps(row))
""",
    "encode_plane": r"""
import chip_smoke
from gowebp_tpu_torch.ops.encode_wavefront import openloop_mode_search
from gowebp_tpu_torch.ops.kernels import encode_plane as ep

buf = saved["buf"].to(dev)
B, H, W = saved["shape"]
ys, cs = H * W, (H // 2) * (W // 2)
y = buf[:, :ys].reshape(B, H, W)
u = buf[:, ys:ys + cs].reshape(B, H // 2, W // 2)
v = buf[:, ys + cs:].reshape(B, H // 2, W // 2)
lq, y2q, cq = saved["quants"]
chunk = {k: (t.to(dev) if torch.is_tensor(t) else
             tuple(x.to(dev) for x in t) if isinstance(t, tuple) else t)
         for k, t in saved["chunk"].items()}
cold = lambda: openloop_mode_search(
    chunk["y"], chunk["u"], chunk["v"], chunk["seg"], chunk["qsteps"],
    chunk["tables"], try_i4=False, i4_penalty=chunk["pens"])
out = {f"luma{i}": t for i, t in enumerate(ep.encode_luma(y, lq, y2q))}
out.update({f"chroma{i}": t for i, t in enumerate(ep.encode_chroma(u, v, cq))})
out.update({f"cold_{k}": t for k, t in cold().items()})
torch.cuda.synchronize()
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[2])
fns = {"luma": lambda: ep.encode_luma(y, lq, y2q),
       "chroma": lambda: ep.encode_chroma(u, v, cq)}
if hasattr(ep, "encode_luma_modes"):
    fns["luma_modes"] = lambda: ep.encode_luma_modes(y)
    fns["chroma_modes"] = lambda: ep.encode_chroma_modes(u, v)
row = {}
for name in ("luma", "chroma", "luma_modes", "chroma_modes"):
    fn = fns.get(name)
    row[f"{name}_ms"] = time_ms(fn, 50) if fn else None
    row[f"{name}_device_ms"] = queued_ms(fn) if fn else None
row["cold_round_ms"] = time_ms(cold, 50)
row["cold_round_device_ms"] = queued_ms(cold, reps=4)
spans = chip_smoke.stage_spans(dev, chunk, reps=10)
row.update({f"span_{k}_ms": ms for k, ms in spans.items()})
print(json.dumps(row))
""",
    "encode_rgba": r"""
import gowebp_tpu_torch as T

rgb = saved["rgb"].numpy()
rgba = saved["rgba"].numpy()
row, out = {}, {}
for name, im, method in (("rgb_m6", rgb, 6), ("rgb_m4", rgb, 4),
                         ("rgba_m4", rgba, 4)):
    data = T.encode_rgba(im, method=method, device="cuda")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.encode_rgba(im, method=method, device="cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    row[name + "_ms"] = statistics.median(times)
    row[name + "_min_ms"] = min(times)
    out[name] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
torch.save(out, sys.argv[2])
print(json.dumps(row))
""",
    "vp8l_predictor": r"""
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke
from gowebp_tpu_torch.models.vp8l import encoder as vp8l_enc
from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm

vpm.LIBRARY.load()
out, row = {}, {}
for name, key, bits in (("b4", "sg", 4), ("b3", "sg", 3), ("b5", "sg", 5),
                        ("alpha_b4", "alpha", 4)):
    x = saved[key].to(dev)
    call = lambda b=bits: vpm.predictor_search_entropy(x, b, 2)
    out[name] = call()
    modes, replay, passes = chip_smoke.chooser_replay(dev, x, bits, 2)
    stage1, replay1, _ = chip_smoke.chooser_replay(dev, x, bits, 0)
    assert torch.equal(modes, out[name])
    out[f"{name}_stage1"] = stage1
    row[f"{name}_ms"] = time_ms(call, 20)
    row[f"{name}_device_ms"] = queued_ms(replay, reps=20)
    row[f"{name}_stage1_device_ms"] = queued_ms(replay1, reps=20)
    row[f"{name}_round_device_ms"] = (
        (row[f"{name}_device_ms"] - row[f"{name}_stage1_device_ms"])
        / max(passes - 1, 1))
    row[f"{name}_launches"] = passes

# the photo path's two choosers at once, as the encoder runs them
pair = [saved[k].numpy().view(np.uint32) for k in ("sg", "rgb")]
with ThreadPoolExecutor(2) as ex:
    def both():
        return list(ex.map(
            lambda a: vp8l_enc._device_modes(a, 4, 2, dev), pair))
    got = both()
    walls = []
    for _ in range(100):
        t0 = time.perf_counter()
        both()
        walls.append((time.perf_counter() - t0) * 1e3)
out["pair_sg"], out["pair_rgb"] = (torch.from_numpy(g) for g in got)
row["pair_wall_ms"] = statistics.median(walls)
row["pair_wall_ms_min_max"] = [min(walls), max(walls)]
torch.cuda.synchronize()
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[2])
print(json.dumps(row))
""",
    "decode": r"""
import hashlib

from gowebp_tpu_torch import decode_rgba_batch

out, row = {}, {}
for name in ("hybrid", "mixed"):
    files = [bytes(t.numpy()) for t in saved[name]]
    got = decode_rgba_batch(files, device="cuda")
    out[name] = torch.tensor([list(hashlib.sha256(g.tobytes()).digest())
                              for g in got], dtype=torch.uint8)
    mp = sum(g.shape[0] * g.shape[1] for g in got) / 1e6
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_rgba_batch(files, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    row[name + "_mps"] = mp / statistics.median(times)
    row[name + "_mps_min_max"] = [mp / max(times), mp / min(times)]
    timings = {}
    decode_rgba_batch(files, device="cuda", timings=timings)
    row[name + "_timings"] = {k: v for k, v in timings.items()
                              if k != "spans"}
torch.save(out, sys.argv[2])
print(json.dumps(row))
""",
    "unpack_coeffs": r"""
from gowebp_tpu_torch.ops.kernels import coeff_unpack as cum

cum.LIBRARY.load()
out, row = {}, {}
for name, packed in saved.items():
    wire = {k: t.to(dev) for k, t in packed.items()}
    call = lambda w=wire: cum.unpack_coeffs(w)
    out[name] = call()
    row[name + "_ms"] = time_ms(call, 20)
    row[name + "_device_ms"] = queued_ms(call)
    row[name + "_tail_rows"] = len(packed["tail_idx"])
torch.cuda.synchronize()
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[2])
print(json.dumps(row))
""",
    "pack": r"""
from concurrent.futures import ThreadPoolExecutor

import chip_smoke
from gowebp_tpu_torch.decode import _pack_group

files = [bytes(t.numpy()) for t in saved["files"]]
recs = chip_smoke.decode_recs(files)
packed, K = _pack_group(recs)
torch.save({k: torch.from_numpy(a.copy()) for k, a in packed.items()},
           sys.argv[2])
one = []
for _ in range(7):
    t0 = time.perf_counter()
    _pack_group(recs)
    one.append((time.perf_counter() - t0) * 1e3 / len(recs))
four = []
with ThreadPoolExecutor(4) as ex:
    list(ex.map(lambda _: _pack_group(recs), range(4)))
    for _ in range(5):
        t0 = time.perf_counter()
        list(ex.map(lambda _: _pack_group(recs), range(4)))
        four.append((time.perf_counter() - t0) * 1e3 / len(recs))
print(json.dumps({"K": K, "one_thread_ms_per_file": statistics.median(one),
                  "one_thread_min_max": [min(one), max(one)],
                  "four_threads_ms_per_file": statistics.median(four),
                  "four_threads_min_max": [min(four), max(four)]}))
""",
    "vp8_recon": r"""
from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr

kvr.LIBRARY.load()
coeffs, modes, fp = (t.to(dev) for t in saved["args"])
mw, mh, ftype = saved["grid"]
one = (coeffs[:1], modes[:1], fp[:1])
steps = (mw - 1) + 2 * (mh - 1) + 1
if hasattr(kvr, "recon_filter_mb"):
    run = lambda c, m, f: kvr.recon_filter_mb(c, m, f, mw, mh, ftype)
    parts = {}
else:
    def run(c, m, f):
        return kvr.loop_filter_mb(*kvr.recon_mb(c, m, mw, mh), f, mw, mh,
                                  ftype)
    planes = kvr.recon_mb(coeffs, modes, mw, mh)
    parts = {"recon_mb": lambda: kvr.recon_mb(coeffs, modes, mw, mh),
             "loop_filter_mb": lambda: kvr.loop_filter_mb(
                 *planes, fp, mw, mh, ftype)}
out = run(coeffs, modes, fp)
torch.cuda.synchronize()
torch.save({k: t.cpu() for k, t in zip("yuv", out)}, sys.argv[2])
b1 = time_ms(lambda: run(*one), 20)
row = {"b32_ms": time_ms(lambda: run(coeffs, modes, fp), 20),
       "b32_device_ms": queued_ms(lambda: run(coeffs, modes, fp), reps=20),
       "b1_ms": b1, "us_per_chained_mb_step": b1 / steps * 1e3}
for name, fn in parts.items():
    row[name + "_b32_device_ms"] = queued_ms(fn, reps=20)
print(json.dumps(row))
""",
    "vp8l_inverse": r"""
from gowebp_tpu_torch.ops.kernels import vp8l_inverse as vim

vim.LIBRARY.load()
out, row = {}, {}
for name in ("b8", "b1", "big"):
    res, modes = (t.to(dev) for t in saved[name])
    call = lambda r=res, m=modes: vim.predictor_inverse(r, m, 4, True)
    out[name] = call()
    _, h, w = res.shape
    row[name + "_ms"] = time_ms(call, 20)
    row[name + "_device_ms"] = queued_ms(call, reps=10)
    row[name + "_us_per_step"] = row[name + "_device_ms"] / (w + 2 * (h - 1)) * 1e3
if hasattr(vim, "launch"):
    res, modes = (t.to(dev) for t in saved["b8"])
    for warps in (1, 2, 4, 8):
        got = vim.launch(res, modes, 4, True, warps)
        assert torch.equal(got, out["b8"]), warps
        row[f"b8_warps{warps}_device_ms"] = queued_ms(
            lambda: vim.launch(res, modes, 4, True, warps), reps=10)
torch.cuda.synchronize()
torch.save({k: t.cpu() for k, t in out.items()}, sys.argv[2])
print(json.dumps(row))
""",
}


def _cpu(t):
    import torch

    if torch.is_tensor(t):
        return t.cpu().contiguous()
    return tuple(x.cpu() for x in t) if isinstance(t, tuple) else t


def wavefront_search_inputs(chip_smoke, dev, images) -> dict:
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search)

    chunk = chip_smoke.chunk_inputs(dev, images[:16])
    args = [chunk[k].contiguous() for k in
            ("y", "u", "v", "seg", "qsteps", "pens")]
    rate = search_tables(chunk["tables"])
    first = wavefront_search(*args, rate, try_i4=True, use_derr=True,
                             want_recon=False)
    trellis = search_tables(chip_smoke.first_pass_tables(first, dev),
                            trellis=True)
    return {"args": [_cpu(t) for t in args], "rate": [t.cpu() for t in rate],
            "trellis_rate": [t.cpu() for t in trellis],
            "lams": chip_smoke.trellis_lambdas(args[4]).cpu()}


def encode_plane_inputs(chip_smoke, dev, images) -> dict:
    import torch

    chunk = chip_smoke.chunk_inputs(dev, images[:16])
    B, H, W = 16, 1024, 1024
    gen = torch.Generator().manual_seed(20261017)
    buf = torch.randint(0, 256, (B, H * W * 3 // 2), generator=gen,
                        dtype=torch.uint8)
    return {"buf": buf, "shape": (B, H, W),
            "quants": chip_smoke.plane_quants(75.0),
            "chunk": {k: _cpu(t) for k, t in chunk.items()}}


def vp8_recon_inputs(chip_smoke, dev, images) -> dict:
    from gowebp_tpu_torch import encode_rgba_batch

    files = encode_rgba_batch(images, quality=75.0, device="cuda")
    coeffs, modes, fp, ftype, mw, mh = chip_smoke.recon_symbols(dev, files)
    return {"args": [_cpu(t) for t in (coeffs, modes, fp)],
            "grid": (mw, mh, ftype)}


def encode_rgba_inputs(chip_smoke, dev, images) -> dict:
    import numpy as np
    import torch

    return {"rgb": torch.from_numpy(np.ascontiguousarray(images[12])),
            "rgba": torch.from_numpy(chip_smoke.soft_alpha_image(images[12]))}


def vp8l_predictor_inputs(chip_smoke, dev, images) -> dict:
    import numpy as np
    import torch

    from gowebp_tpu_torch.models.vp8l import transforms_np as tnp

    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
            np.int32))

    rgb = chip_smoke.rgb_words(images[12])
    return {"sg": words(tnp.subtract_green_forward(rgb)), "rgb": words(rgb),
            "alpha": words(chip_smoke.rgba_words(
                chip_smoke.soft_alpha_image(images[12])))}


def decode_inputs(chip_smoke, dev, images) -> dict:
    import torch

    from gowebp_tpu_torch import encode_rgba_batch

    files = encode_rgba_batch(images, quality=75.0, device="cuda")
    alpha, lossless = chip_smoke.mixed_decode_files(images)
    mixed = list(files)
    for k, data in enumerate(alpha + lossless):
        mixed.insert(5 * k + 2, data)

    def t(d):
        return torch.frombuffer(bytearray(d), dtype=torch.uint8)

    return {"hybrid": [t(d) for d in files], "mixed": [t(d) for d in mixed]}


def unpack_coeffs_inputs(chip_smoke, dev, images) -> dict:
    import torch

    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.decode import _pack_group

    def packed(recs, K):
        with chip_smoke.forced_k(K):
            p, k = _pack_group(recs)
        assert K is None or k == K
        return {name: torch.from_numpy(a) for name, a in p.items()}

    recs = chip_smoke.decode_recs(
        encode_rgba_batch(images, quality=75.0, device="cuda"))
    out = {f"k{K}": packed(recs, K) for K in (4, 8, 16)}
    out["k4_bare"] = dict(out["k4"], tail_idx=out["k4"]["tail_idx"][:0],
                          tail_val=out["k4"]["tail_val"][:0])
    smooth = encode_rgba_batch(chip_smoke.smooth_images(16, 1024, 1024, 5),
                               quality=95.0, device="cuda")
    out["q95"] = packed(chip_smoke.decode_recs(smooth), None)
    return out


def pack_inputs(chip_smoke, dev, images) -> dict:
    import io

    import torch
    from PIL import Image

    def one(im):
        b = io.BytesIO()
        Image.fromarray(im).save(b, "WEBP", quality=75, method=4)
        return torch.frombuffer(bytearray(b.getvalue()), dtype=torch.uint8)

    return {"files": [one(im) for im in images]}


def vp8l_inverse_inputs(chip_smoke, dev, images) -> dict:
    b8 = chip_smoke.lossless_case(dev, images[:8], 4, seed=19)[:2]
    big = chip_smoke.lossless_case(dev, [chip_smoke.mosaic(images[:16], 4)],
                                   4, seed=20)[:2]
    return {"b8": [t.cpu() for t in b8],
            "b1": [b8[0][:1].cpu().contiguous(), b8[1].cpu()],
            "big": [t.cpu() for t in big]}


INPUTS = {"wavefront_search": wavefront_search_inputs,
          "decode": decode_inputs,
          "encode_plane": encode_plane_inputs,
          "encode_rgba": encode_rgba_inputs,
          "unpack_coeffs": unpack_coeffs_inputs,
          "pack": pack_inputs,
          "vp8_recon": vp8_recon_inputs,
          "vp8l_inverse": vp8l_inverse_inputs,
          "vp8l_predictor": vp8l_predictor_inputs}


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--kernel", required=True, choices=sorted(RUNS))
    parser.add_argument("checkouts", nargs="+")
    opts = parser.parse_args(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from gowebp_tpu_torch.ops.kernels.cuda_build import BUILD_DIR
    from gowebp_tpu_torch.utils.corpus import natural_images

    dev = torch.device("cuda:0")
    images = list(natural_images(32, 1024, 1024, seed=7))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    inputs = BUILD_DIR / f"ab_{opts.kernel}_inputs.pt"
    torch.save(INPUTS[opts.kernel](chip_smoke, dev, images), inputs)
    card = chip_smoke.card_line()
    first = None
    ok = True
    for i, checkout in enumerate(opts.checkouts):
        out = BUILD_DIR / f"ab_{opts.kernel}_out{i}.pt"
        proc = subprocess.run(
            [sys.executable, "-c", COMMON + RUNS[opts.kernel], str(inputs),
             str(out)],
            cwd=Path(checkout).resolve(), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(out)
        if first is None:
            first = got
        same = set(got) == set(first) and all(
            torch.equal(got[k], first[k]) for k in first)
        ok = ok and same
        print(json.dumps({"run": i + 1, "checkout": checkout,
                          "kernel": opts.kernel, "equal_to_run_1": same,
                          **row, "card": card}), flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
