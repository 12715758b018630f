"""gowebp_tpu_torch — the WebP codec's encode and decode on PyTorch +
CUDA.

A port of the gowebp_tpu package's single-image encode (lossy and
lossless), batch encode (hybrid, exact wavefront and open-loop engines),
batch decode and single-file decode to PyTorch with hand-written Hopper
(sm_90a) CUDA kernels.  Entry points: ``encode_rgba(rgba, lossless=False,
quality=75.0, method=4, config=None, stats=None, device=None)`` and
``encode_yuv(y, u, v, alpha=None, ...)`` with ``EncoderConfig`` and
``EncodeStats``;
``encode_rgba_batch(images, quality=75.0, device=None,
engine="hybrid"|"wavefront"|"openloop")``;
``decode_rgba_batch(datas, device=None, device_out=False,
recon_backend="device"|"host")``, which decodes every still .webp kind
(lossy, lossy with an ALPH chunk, lossless VP8L) in any mix; and the
single-file ``decode(data, config=None, mode="RGBA", device=None)`` with
``decode_rgba``, ``decode_rgb``, ``decode_into``, ``decode_yuv``,
``decode_yuva``, ``features`` and ``DecoderConfig``; the push decoder
``IncrementalDecoder(device=None)`` (``append`` bytes, read the finished
rows with ``get_partial_output``); and the picture helpers
``picture_view``, ``picture_crop`` and ``picture_rescale(rgba, width,
height, device=None)``.
Containers and animation: ``container.mux`` (``Mux``, ``MuxFrame``),
``container.demux`` (``demux``, ``Demuxer``, ``FrameInfo``) and
``container.anim`` (``AnimationEncoder(..., device=None)``, whose frames
encode through ``encode_rgba``, and ``decode_animation(data,
device=None)``, whose frames decode in one ``decode_rgba_batch`` call);
``utils.bittrace.bit_accounting`` and ``utils.metrics`` (``psnr``,
``plane_psnr``, ``ssim``), on the host; and the command line,
``python -m gowebp_tpu_torch encode|decode|info``.  ``device`` None
means CUDA and raises without it; ``device="cpu"`` runs the kernels'
plain torch versions and gives identical bytes and pixels.
"""

from .decode import (decode, decode_into, decode_rgb, decode_rgba,
                     decode_rgba_batch, decode_yuv, decode_yuva, features)
from .config import EncoderConfig
from .decode_options import DecoderConfig
from .encode import encode_rgba, encode_rgba_batch, encode_yuv
from .errors import (BitstreamError, EncodeError, InvalidConfig,
                     NotEnoughData, UnsupportedFeature, WebPError)
from .idec import IncrementalDecoder
from .picture import picture_crop, picture_rescale, picture_view
from .stats import EncodeStats

__version__ = "0.1.0"

__all__ = [
    "BitstreamError",
    "DecoderConfig",
    "EncodeError",
    "EncodeStats",
    "EncoderConfig",
    "IncrementalDecoder",
    "InvalidConfig",
    "NotEnoughData",
    "UnsupportedFeature",
    "WebPError",
    "__version__",
    "decode",
    "decode_into",
    "decode_rgb",
    "decode_rgba",
    "decode_rgba_batch",
    "decode_yuv",
    "decode_yuva",
    "encode_rgba",
    "encode_rgba_batch",
    "encode_yuv",
    "features",
    "picture_crop",
    "picture_rescale",
    "picture_view",
]
