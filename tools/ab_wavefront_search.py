#!/usr/bin/env python3
"""Time the wavefront_search kernel of several checkouts in turns, on one
card, on the same inputs.

    python3 tools/ab_wavefront_search.py CHECKOUT [CHECKOUT ...]

e.g. ``python3 tools/ab_wavefront_search.py _archive/parent . . _archive/parent``
(a parent unpacked with ``git archive`` under ``_archive/``, which
``.gitignore`` lists) for the order parent, change, change, parent.

The inputs are the exact engine's chunk: the first 16 of
``natural_images(32, 1024, 1024, seed=7)`` through the encode pipeline's
own host steps at q75 (``chip_smoke.chunk_inputs`` of this checkout),
saved once.  Each checkout then runs in a process of its own, which
builds its own ``ops/kernels/wavefront_search.cu`` (nvcc) and times its
own ``wavefront_search`` wrapper with CUDA events (median of 5 after a
warm-up): B=16 at 1024x1024 with try_i4 and diffusion on (the exact
engine's call), the try_i4=False form, and B=1 (one image: the chain of
190 MB steps).  Every run's outputs must equal the first run's, bit for
bit.  Prints one JSON line per run, the card's name and power limit,
and exits 1 on a mismatch.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
from gowebp_tpu_torch.ops.kernels.wavefront_search import (LIBRARY,
                                                           wavefront_search)

def time_ms(fn, reps=5):
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

LIBRARY.load()
saved = torch.load(sys.argv[1])
dev = torch.device("cuda:0")
args = tuple(t.to(dev) for t in saved["args"])
rate = tuple(t.to(dev) for t in saved["rate"])
run = lambda a, i4: wavefront_search(*a, rate, try_i4=i4, use_derr=True,
                                     want_recon=True)
out = run(args, True)
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[2])
one = tuple(t[:1].contiguous() for t in args)
B, H, W = args[0].shape
steps = (W // 16 - 1) + 2 * (H // 16 - 1) + 1
b1 = time_ms(lambda: run(one, True))
print(json.dumps({"b16_ms": time_ms(lambda: run(args, True)),
                  "lean_ms": time_ms(lambda: run(args, False)),
                  "b1_ms": b1, "us_per_chained_mb_step": b1 / steps * 1e3,
                  "i4_share": out["is_i4"].float().mean().item()}))
"""


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab_wavefront_search: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from gowebp_tpu_torch.ops.kernels.cuda_build import BUILD_DIR
    from gowebp_tpu_torch.ops.kernels.wavefront_search import search_tables
    from gowebp_tpu_torch.utils.corpus import natural_images

    dev = torch.device("cuda:0")
    images = list(natural_images(32, 1024, 1024, seed=7))[:16]
    chunk = chip_smoke.chunk_inputs(dev, images)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    inputs = BUILD_DIR / "ab_wavefront_search_inputs.pt"
    torch.save({"args": [chunk[k].cpu().contiguous() for k in
                         ("y", "u", "v", "seg", "qsteps", "pens")],
                "rate": [t.cpu() for t in search_tables(chunk["tables"])]},
               inputs)
    card = chip_smoke.card_line()
    first = None
    ok = True
    for i, checkout in enumerate(argv[1:]):
        out = BUILD_DIR / f"ab_wavefront_search_out{i}.pt"
        proc = subprocess.run(
            [sys.executable, "-c", RUN, str(inputs), str(out)],
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
                          "equal_to_run_1": same, **row, "card": card}),
              flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
