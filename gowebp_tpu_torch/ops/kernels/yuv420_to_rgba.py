"""Chroma upsampling (fancy or nearest) + YUV→RGBA: the Hopper kernel,
its binding and its plain version.

``yuv420_to_rgba`` turns the decoder's MB-padded uint8 planes into the
cropped (B, H, W, 4) uint8 RGBA images.  On a CUDA tensor it launches the
kernel in ``yuv420_to_rgba.cu`` (replacing the TPU kernel
gowebp_tpu/ops/pallas/decode_post.py); on a CPU tensor it runs
``yuv420_to_rgba_plain``, which crops and calls ops/yuv.py.

Layout:
  y       (B, Hy, Wy) uint8, Hy >= H and Wy >= W (padding is ignored)
  u, v    (B, Hc, Wc) uint8, Hc >= ceil(H/2) and Wc >= ceil(W/2)
  alpha   None (alpha 255) or (B, H, W) uint8
  fancy   True: libwebp's fancy upsampler; False: nearest chroma samples
          (the decoder's ``no_fancy_upsampling``)
"""

from __future__ import annotations

import ctypes

import torch

from ..yuv import batch_yuv_to_rgba
from .cuda_build import CudaLibrary, check_tensor, stream_handle

U8 = torch.uint8


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.yuv420_to_rgba_launch.restype = ctypes.c_int
    lib.yuv420_to_rgba_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                          i, p, p]


LIBRARY = CudaLibrary("yuv420_to_rgba.cu", _configure)


def _check_shapes(y, u, v, height: int, width: int) -> None:
    B, Hy, Wy = y.shape
    h2, w2 = (height + 1) // 2, (width + 1) // 2
    if height <= 0 or width <= 0 or Hy < height or Wy < width:
        raise ValueError(f"yuv420_to_rgba: luma plane {tuple(y.shape)} "
                         f"does not hold {height}x{width}")
    for name, c in (("u", u), ("v", v)):
        if c.dim() != 3 or c.shape[0] != B or c.shape[1] < h2 \
                or c.shape[2] < w2:
            raise ValueError(f"yuv420_to_rgba: {name} plane "
                             f"{tuple(c.shape)} does not hold {h2}x{w2}")
    if u.shape != v.shape:
        raise ValueError("yuv420_to_rgba: u and v planes differ in shape")


def yuv420_to_rgba_plain(y, u, v, height: int, width: int, alpha=None,
                         fancy: bool = True):
    """Plain torch version of the kernel (any device)."""
    _check_shapes(y, u, v, height, width)
    h2, w2 = (height + 1) // 2, (width + 1) // 2
    return batch_yuv_to_rgba(y[:, :height, :width], u[:, :h2, :w2],
                             v[:, :h2, :w2], alpha, fancy=fancy)


def yuv420_to_rgba(y, u, v, height: int, width: int, alpha=None,
                   fancy: bool = True):
    """Kernel on a CUDA tensor, plain version on a CPU tensor.

    ``yuv420_to_rgba.launches`` counts kernel launches (one per call on
    CUDA); ``yuv420_to_rgba.alpha_launches`` those of them that read an
    alpha plane.
    """
    dev = y.device
    if dev.type == "cpu":
        return yuv420_to_rgba_plain(y, u, v, height, width, alpha, fancy)
    if dev.type != "cuda":
        raise ValueError(f"yuv420_to_rgba: unsupported device {dev}")
    if y.dim() != 3:
        raise ValueError(f"yuv420_to_rgba: y must be (B, H, W), got "
                         f"{tuple(y.shape)}")
    _check_shapes(y, u, v, height, width)
    B = y.shape[0]
    check_tensor("y", y, U8, y.shape, dev)
    check_tensor("u", u, U8, u.shape, dev)
    check_tensor("v", v, U8, u.shape, dev)
    if alpha is not None:
        check_tensor("alpha", alpha, U8, (B, height, width), dev)
    lib = LIBRARY.load()
    out = torch.empty((B, height, width, 4), dtype=U8, device=dev)
    err = lib.yuv420_to_rgba_launch(
        y.data_ptr(), u.data_ptr(), v.data_ptr(),
        None if alpha is None else alpha.data_ptr(),
        B, height, width, y.shape[1], y.shape[2], u.shape[1], u.shape[2],
        int(bool(fancy)), out.data_ptr(), stream_handle(dev))
    if err != 0:
        raise RuntimeError(
            f"yuv420_to_rgba kernel launch failed: CUDA error {err}")
    yuv420_to_rgba.launches += 1
    if alpha is not None:
        yuv420_to_rgba.alpha_launches += 1
    return out


yuv420_to_rgba.launches = 0
yuv420_to_rgba.alpha_launches = 0

__all__ = ["LIBRARY", "yuv420_to_rgba", "yuv420_to_rgba_plain"]
