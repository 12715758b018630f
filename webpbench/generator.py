"""The one traffic generator: it reads a mix's parameters (traffic/<mix>.json)
and a configuration's settings (configs/<config>.json), makes the inputs
from the seed, warms the cell's shape up and drives the program's batch
entry points back to back (a closed loop) for the window.

A mix's parameters:
  op          "encode" (encode_rgba_batch) or "decode" (decode_rgba_batch)
  metric      the end-to-end rate it reports ("encode_mps", "decode_mps")
  pool        distinct images (and, to decode, files) made from the seed
  batch       items a call; m = batch/pool a whole number that divides
              ``pool``: every call holds each pool item m times, in an
              order the seed shuffles (``call_order``)
  device_out  decode only: leave the pixels on the card

A configuration's ``image`` and ``decode_files`` (all keys but the first
of each optional; where one is absent the inputs are those of a pool of
``height`` x ``width`` RGB images coded at ``quality`` and ``method``):
  image.height, image.width   every item's size, where ``sizes`` is absent
  image.sizes                 [[height, width], ...]: pool/len(sizes) items
                              of each size, which item gets which drawn
                              from the seed (every seed does the same work)
  image.channels, image.alpha 4 and the name of a model in alpha_models.py:
                              RGBA sources (decode mixes only)
  decode_files.libwebp_version, .quality, .method; .lossless, .exact,
  .alpha_quality              passed to Pillow's WebP writer where stated
"""

from __future__ import annotations

import io
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np

from .alpha_models import MODELS
from .bench import log
from .corpus import natural_image

PILLOW_OPTIONS = ("lossless", "exact", "alpha_quality")


@dataclass
class Inputs:
    images: list                    # (H, W, 3 or 4) uint8 sources, an item
    files: list | None = None       # the pool's .webp files, to decode


@dataclass
class Window:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0
    failed: int = 0
    megapixels: float = 0.0
    orders: list = field(default_factory=list)       # pool indices a call
    kept: list = field(default_factory=list)         # (pool index, output)
    first: dict = field(default_factory=dict)        # pool index -> output
    timings: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)
    call_s: list = field(default_factory=list)       # each call's seconds


def check_params(traffic: dict, config: dict | None = None) -> None:
    """Refuses a mix, or a configuration's image for that mix, that the
    generator cannot make."""
    if traffic["op"] not in ("encode", "decode"):
        raise ValueError(f"unknown op {traffic['op']!r}")
    pool, batch = traffic["pool"], traffic["batch"]
    if batch % pool or pool % (batch // pool):
        raise ValueError("batch must be m * pool with m dividing pool")
    if config is None:
        return
    im = config["image"]
    sizes = im.get("sizes")
    if sizes is not None:
        if not sizes or pool % len(sizes):
            raise ValueError(f"pool {pool} is not a multiple of the "
                             f"{len(sizes)} image.sizes")
        if any(len(s) != 2 or min(s) < 1 for s in sizes):
            raise ValueError(f"image.sizes must be [height, width] pairs: "
                             f"{sizes}")
    channels = im.get("channels", 3)
    if channels == 4:
        if im.get("alpha") not in MODELS:
            raise ValueError(f"image.alpha must name one of {sorted(MODELS)}")
        if traffic["op"] != "decode":
            raise ValueError("RGBA sources are for decode mixes only")
    elif channels != 3 or "alpha" in im:
        raise ValueError(f"image.channels {channels} with image.alpha "
                         f"{im.get('alpha')!r}")


def seed_words(seed: int, stream: int) -> list:
    """Entropy words of a (possibly large) seed and a stream number."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, int(s < 0), stream]


def libwebp_files(images, src: dict) -> list:
    """.webp files of ``images`` by the libwebp that Pillow carries, which
    must be version ``src["libwebp_version"]``, at ``src``'s quality and
    method, and its lossless, exact and alpha_quality where it states
    them."""
    from PIL import Image, features

    have, want = features.version("webp"), src["libwebp_version"]
    if have != want:
        raise RuntimeError(f"Pillow carries libwebp {have}, the configuration "
                           f"states {want}")
    opts = {"quality": src["quality"], "method": src["method"],
            **{k: src[k] for k in PILLOW_OPTIONS if k in src}}

    def one(im):
        b = io.BytesIO()
        Image.fromarray(im).save(b, "WEBP", **opts)
        return b.getvalue()

    with ThreadPoolExecutor(4) as ex:
        return list(ex.map(one, images))


def item_sizes(image: dict, pool: int, seed: int) -> list:
    """(height, width) of each pool item."""
    if "sizes" not in image:
        return [(image["height"], image["width"])] * pool
    sizes = [tuple(s) for s in image["sizes"]]
    turn = np.random.default_rng(seed_words(seed, 4)).permutation(pool)
    return [sizes[k % len(sizes)] for k in turn]


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    """The pool's images (item i: ``natural_image`` of seed
    seed * 1000 + i, as ``corpus.natural_images`` makes them, and with
    RGBA sources the alpha model's plane of the same seed) and, to decode,
    their files."""
    im = config["image"]
    sizes = item_sizes(im, traffic["pool"], seed)
    alpha = im.get("alpha") if im.get("channels", 3) == 4 else None

    def one(i):
        h, w = sizes[i]
        rgb = natural_image(h, w, seed=seed * 1000 + i)
        if alpha is None:
            return rgb
        return np.dstack([rgb, MODELS[alpha](h, w, seed * 1000 + i)])

    with ThreadPoolExecutor(min(4, len(sizes))) as ex:
        images = list(ex.map(one, range(len(sizes))))
    inp = Inputs(images=images)
    if traffic["op"] == "decode":
        inp.files = libwebp_files(images, config["decode_files"])
    return inp


class Program:
    """The system under test, called as a user calls it."""

    def __init__(self, config: dict, traffic: dict, device=None):
        import torch

        import gowebp_tpu_torch

        self.torch = torch
        self.g = gowebp_tpu_torch
        self.settings = config["settings"]
        self.device_out = bool(traffic.get("device_out", False))
        self.device = device
        self.cuda = device is None or str(device).startswith("cuda")

    def check_settings(self) -> None:
        """The configuration's settings are the entry points' defaults."""
        from gowebp_tpu_torch.config import EncoderConfig

        cfg = EncoderConfig()
        for k, v in self.settings.items():
            if k in ("engine", "quality"):
                continue
            if getattr(cfg, k) != v:
                raise RuntimeError(f"EncoderConfig().{k} is "
                                   f"{getattr(cfg, k)!r}, the configuration "
                                   f"states {v!r}")

    def encode(self, images, timings=None):
        q, engine = self.settings["quality"], self.settings["engine"]
        if timings is None:
            return self.g.encode_rgba_batch(images, quality=q, engine=engine,
                                            device=self.device)
        # encode_rgba_batch's own call of its pipeline, with timings
        from gowebp_tpu_torch.ops.encode_pipeline import (
            encode_rgba_batch_pipelined)

        n = len(images)
        return encode_rgba_batch_pipelined(
            images, quality=q, threads=min(8, n), chunk=min(16, n),
            device=self.device, engine=engine, timings=timings)

    def decode(self, files, timings=None):
        out = self.g.decode_rgba_batch(files, device=self.device,
                                       device_out=self.device_out,
                                       timings=timings)
        if self.cuda:
            self.torch.cuda.synchronize()
        return out


def _call_items(inputs: Inputs, traffic: dict, idx):
    if traffic["op"] == "encode":
        return [inputs.images[i] for i in idx]
    return [inputs.files[i] for i in idx]


def _copy(out):
    if isinstance(out, (bytes, bytearray)):
        return out
    return out.clone() if hasattr(out, "clone") else np.array(out)


def call_order(rng, traffic: dict) -> np.ndarray:
    """Pool indices of one call: m = batch/pool copies of the pool, laid
    out so that every stride-m lane (``idx[r::m]``) and every run of
    ``pool`` consecutive items holds each pool item once.  However the
    program splits a call into groups of ``pool`` (decode_rgba_batch's
    symbol engines take file k in group k mod m; encode chunks are runs), no
    group holds an item twice, so no engine lane repeats another's work.

    The pool is cut into m seeded sets; block g of the call (its g-th run
    of ``pool``) puts set (a[g] + b[r]) mod m, shuffled, in lane r, a Latin
    square over blocks and lanes."""
    pool, batch = traffic["pool"], traffic["batch"]
    m = batch // pool
    sets = rng.permutation(pool).reshape(m, pool // m)
    a, b = rng.permutation(m), rng.permutation(m)
    blocks = [np.stack([rng.permutation(sets[(a[g] + b[r]) % m])
                        for r in range(m)], axis=1).ravel()
              for g in range(m)]
    return np.concatenate(blocks)


def warm_up(program: Program, inputs: Inputs, traffic: dict, seed: int,
            with_timings: bool) -> None:
    """One call of the cell's own shape (every kernel built and loaded)."""
    rng = np.random.default_rng(seed_words(seed, 1))
    items = _call_items(inputs, traffic, call_order(rng, traffic))
    op = program.encode if traffic["op"] == "encode" else program.decode
    op(items, timings={} if with_timings else None)


def run_window(program: Program, inputs: Inputs, traffic: dict, seed: int,
               seconds: float, keep: int, timed: bool = False,
               profiler_span=None, stream: int = 0) -> Window:
    """Calls back to back until ``seconds`` have passed; the window ends
    with the call that ends at or after that.  Outputs are kept for the
    check: every output of an encode; of a decode, one output of every pool
    file in the first call that returns, then one of ``keep`` files a call,
    taking the pool's files in turn in an order the seed draws, each at one
    of its positions that the seed draws.  ``timed`` passes the program a
    ``timings`` dict to fill; ``profiler_span`` marks the calls for a trace,
    and an encode under it also keeps each pool item's first file, for the
    per-layer counts."""
    rng = np.random.default_rng(seed_words(seed, 2 + 10 * stream))
    pick = np.random.default_rng(seed_words(seed, 3 + 10 * stream))
    encode = traffic["op"] == "encode"
    op = program.encode if encode else program.decode
    pixels = np.array([im.shape[0] * im.shape[1] for im in inputs.images])
    pool = traffic["pool"]
    turn, nxt = pick.permutation(pool), None
    win = Window()
    span = profiler_span or (lambda name: nullcontext())
    t0 = time.perf_counter()
    while True:
        with span("between_calls"):
            idx = call_order(rng, traffic)
            items = _call_items(inputs, traffic, idx)
        with span("call"):
            tc = time.perf_counter()
            try:
                out = op(items, timings=win.timings if timed else None)
            except Exception as e:      # a failed call counts its items
                out = None
                win.errors.append(repr(e))
            win.call_s.append(time.perf_counter() - tc)
        with span("between_calls"):
            win.calls += 1
            win.items += len(idx)
            win.orders.append(idx)
            if out is None or len(out) != len(idx):
                win.failed += len(idx)
                if out is not None:
                    win.errors.append(f"{len(out)} outputs for {len(idx)}")
            else:
                win.megapixels += int(pixels[idx].sum()) / 1e6
                if encode:
                    pos = range(len(idx))
                else:
                    if nxt is None:         # the first call: every file
                        files, nxt = turn, 0
                    else:
                        files = turn[(nxt + np.arange(min(keep, pool)))
                                     % pool]
                        nxt += keep
                    pos = sorted(int(pick.choice(np.flatnonzero(idx == f)))
                                 for f in files)
                # a copy: an output may be a view of the whole call's batch
                win.kept.extend((int(idx[k]), _copy(out[k])) for k in pos)
                if profiler_span is not None and encode:
                    for k, i in enumerate(idx):
                        win.first.setdefault(int(i), out[k])
            del out, items
        if time.perf_counter() - t0 >= seconds:
            break
    win.seconds = time.perf_counter() - t0
    if win.errors:
        log(f"{len(win.errors)} call errors, first: {win.errors[0]}")
    return win
