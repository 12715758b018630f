"""Command-line interface: cwebp/dwebp-style tools on the card.

Usage:
  python -m gowebp_tpu_torch encode input.png output.webp [--lossless]
      [--quality 75] [--method 4] [--near-lossless N] [--target-size N]
      [--sharp-yuv] [--autofilter] [--partitions N] [--segments N] [-v]
      [--device cpu]
  python -m gowebp_tpu_torch decode input.webp output.png [--crop L T W H]
      [--scale W H] [--mode RGBA] [--no-fancy] [--no-filter] [--device cpu]
  python -m gowebp_tpu_torch info file.webp

``encode`` and ``decode`` run on CUDA unless ``--device cpu`` is given
(the kernels' plain versions, identical bytes and pixels); without CUDA
they exit non-zero.  ``info`` parses headers on the host.  Images are
read and written through Pillow.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_encode(args) -> int:
    import numpy as np
    from PIL import Image

    from .config import EncoderConfig
    from .encode import encode_rgba
    from .stats import EncodeStats

    img = np.asarray(Image.open(args.input).convert("RGBA"))
    cfg = EncoderConfig(
        lossless=args.lossless,
        quality=args.quality,
        method=args.method,
        near_lossless=args.near_lossless,
        target_size=args.target_size,
        use_sharp_yuv=args.sharp_yuv,
        autofilter=args.autofilter,
        partitions=args.partitions,
        segments=args.segments,
    )
    stats = EncodeStats()
    data = encode_rgba(img, config=cfg, stats=stats, device=args.device)
    with open(args.output, "wb") as f:
        f.write(data)
    if args.verbose:
        print(f"{args.output}: {len(data)} bytes", file=sys.stderr)
        print(json.dumps(stats.__dict__, default=str, indent=2),
              file=sys.stderr)
    return 0


def _cmd_decode(args) -> int:
    from PIL import Image

    from .decode import decode
    from .decode_options import DecoderConfig

    cfg = DecoderConfig()
    if args.crop:
        cfg.use_cropping = True
        (cfg.crop_left, cfg.crop_top, cfg.crop_width,
         cfg.crop_height) = args.crop
    if args.scale:
        cfg.use_scaling = True
        cfg.scaled_width, cfg.scaled_height = args.scale
    cfg.no_fancy_upsampling = args.no_fancy
    cfg.bypass_filtering = args.no_filter
    with open(args.input, "rb") as f:
        data = f.read()
    out = decode(data, cfg, mode=args.mode, device=args.device)
    Image.fromarray(out).save(args.output)
    return 0


def _cmd_info(args) -> int:
    from .container.demux import demux
    from .decode import features

    with open(args.input, "rb") as f:
        data = f.read()
    feat = features(data)
    d = demux(data)
    info = {
        "width": feat.width,
        "height": feat.height,
        "format": feat.format,
        "has_alpha": feat.has_alpha,
        "has_animation": feat.has_animation,
        "frames": d.num_frames,
        "loop_count": d.loop_count,
        "metadata": [
            k for k, v in (("icc", d.iccp), ("exif", d.exif), ("xmp", d.xmp))
            if v is not None
        ],
        "size_bytes": len(data),
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gowebp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="image → .webp (cwebp equivalent)")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--lossless", action="store_true")
    e.add_argument("--quality", type=float, default=75.0)
    e.add_argument("--method", type=int, default=4)
    e.add_argument("--near-lossless", type=int, default=100)
    e.add_argument("--target-size", type=int, default=0)
    e.add_argument("--sharp-yuv", action="store_true")
    e.add_argument("--autofilter", action="store_true")
    e.add_argument("--partitions", type=int, default=0)
    e.add_argument("--segments", type=int, default=4)
    e.add_argument("-v", "--verbose", action="store_true")
    e.set_defaults(fn=_cmd_encode)

    d = sub.add_parser("decode", help=".webp → image (dwebp equivalent)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--crop", type=int, nargs=4, metavar=("L", "T", "W", "H"))
    d.add_argument("--scale", type=int, nargs=2, metavar=("W", "H"))
    d.add_argument("--mode", default="RGBA")
    d.add_argument("--no-fancy", action="store_true")
    d.add_argument("--no-filter", action="store_true")
    d.set_defaults(fn=_cmd_decode)

    for cmd in (e, d):
        cmd.add_argument("--device", default=None,
                         help="torch device (default: cuda; cpu runs the "
                              "kernels' plain versions)")

    i = sub.add_parser("info", help="probe a .webp file")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
