#!/usr/bin/env python3
"""Probe the first partition of the port's lossy files of one large image.

    python3 tools/probe_partition0.py [SIDE]      (default 4096; needs a card)

Encodes a SIDE x SIDE mosaic of corpus images (``natural_images(n*n,
1024, 1024, seed=7)``, n = SIDE / 1024) with the hybrid batch engine on
the card and prints the file's size, the first-partition length its
frame tag holds (19 bits: a partition of 512 KiB or more does not fit),
and whether Pillow (libwebp), the port's single-stream symbol decoder
and its batch symbol decoder read it (the batch decoder's parked lanes
once walked off its arena on such a file); then encodes the same image
through the single-image ``encode_rgba`` with statistics and prints its
first partition's size, or the exception it raises (EncodeError where
that partition does not fit the frame tag).
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gowebp_tpu_torch import EncodeStats, encode_rgba, encode_rgba_batch
    from gowebp_tpu_torch.constants import CHUNK_VP8
    from gowebp_tpu_torch.container.riff import parse_riff
    from gowebp_tpu_torch.models.vp8.decoder import (
        decode_vp8_symbols, decode_vp8_symbols_batch)
    from gowebp_tpu_torch.utils.corpus import natural_images

    side = int(argv[0]) if argv else 4096
    n = side // 1024
    big = cs.mosaic(list(natural_images(n * n, 1024, 1024, seed=7)), n)
    data = encode_rgba_batch([big], quality=75.0, device="cuda")[0]
    p = parse_riff(data).find(CHUNK_VP8).payload
    tag = p[0] | p[1] << 8 | p[2] << 16
    print(f"hybrid {side}x{side} file: {len(data)} bytes; the tag's "
          f"first-partition length {tag >> 5}", flush=True)
    for name, fn in (("Pillow", lambda: cs.pillow_rgba(data)),
                     ("the single-stream symbol decoder",
                      lambda: decode_vp8_symbols(p)),
                     ("the batch symbol decoder",
                      lambda: decode_vp8_symbols_batch([p]))):
        try:
            fn()
            print(f"{name} reads it", flush=True)
        except Exception as e:  # noqa: BLE001  (reported, not handled)
            print(f"{name} fails: {type(e).__name__}: {e}", flush=True)
    stats = EncodeStats()
    try:
        encode_rgba(big, quality=75.0, device="cuda", stats=stats)
        print(f"single-image encode: first partition {stats.header_bytes} "
              f"bytes", flush=True)
    except Exception as e:  # noqa: BLE001  (reported, not handled)
        print(f"single-image encode fails: {type(e).__name__}: {e}",
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
