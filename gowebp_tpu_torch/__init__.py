"""gowebp_tpu_torch — the WebP codec's batch lossy encode and batch decode
on PyTorch + CUDA.

A port of the gowebp_tpu package's batch encode (hybrid, exact
wavefront and open-loop engines) and batch decode to PyTorch with
hand-written Hopper (sm_90a) CUDA kernels.  Entry points:
``encode_rgba_batch(images, quality=75.0, device=None,
engine="hybrid"|"wavefront"|"openloop")`` and
``decode_rgba_batch(datas, device=None, device_out=False,
recon_backend="device"|"host")``, which decodes every still .webp kind
(lossy, lossy with an ALPH chunk, lossless VP8L) in any mix; ``device``
None means CUDA, ``device="cpu"`` runs the kernels' plain torch versions
and gives identical bytes and pixels.
"""

from .decode import decode_rgba_batch
from .encode import encode_rgba_batch

__all__ = ["decode_rgba_batch", "encode_rgba_batch"]
