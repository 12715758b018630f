"""Decoder options: cropping, scaling and flipping of the decoded pixels.

``DecoderConfig`` carries libwebp's WebPDecoderOptions; the output
options run as torch integer ops where the pixels are (on the card for a
lossy file, on the host for a lossless one).  Written from the WebP
decoder API (WebPDecoderOptions, WebPRescaler).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .errors import InvalidConfig


@dataclass
class DecoderConfig:
    bypass_filtering: bool = False        # skip the in-loop filter (VP8)
    no_fancy_upsampling: bool = False     # nearest-neighbor chroma
    use_cropping: bool = False
    crop_left: int = 0
    crop_top: int = 0
    crop_width: int = 0
    crop_height: int = 0
    use_scaling: bool = False
    scaled_width: int = 0
    scaled_height: int = 0
    use_threads: bool = False             # accepted; batch-level parallelism
    dithering_strength: int = 0           # 0..100 (VP8 chroma dither)
    flip: bool = False                    # vertical flip
    alpha_dithering_strength: int = 0     # 0..100

    def validate(self, width: int, height: int) -> None:
        if self.use_cropping:
            if (
                self.crop_width <= 0
                or self.crop_height <= 0
                or self.crop_left < 0
                or self.crop_top < 0
                or self.crop_left + self.crop_width > width
                or self.crop_top + self.crop_height > height
            ):
                raise InvalidConfig("bad crop rectangle")
        if self.use_scaling and (self.scaled_width <= 0 and self.scaled_height <= 0):
            raise InvalidConfig("bad scaling dimensions")
        if not (0 <= self.dithering_strength <= 100):
            raise InvalidConfig("dithering_strength in [0,100]")
        if not (0 <= self.alpha_dithering_strength <= 100):
            raise InvalidConfig("alpha_dithering_strength in [0,100]")

    def resolve_scale(self, width: int, height: int) -> tuple[int, int]:
        """Fill a missing scaled dimension preserving aspect ratio."""
        sw, sh = self.scaled_width, self.scaled_height
        if sw == 0:
            sw = max(1, width * sh // height)
        if sh == 0:
            sh = max(1, height * sw // width)
        return sw, sh


def apply_output_options(rgba, config: DecoderConfig):
    """Crop → scale → flip of an (H, W, C) uint8 tensor, on its device;
    returns a contiguous tensor."""
    h, w = rgba.shape[:2]
    config.validate(w, h)
    out = rgba
    if config.use_cropping:
        out = out[
            config.crop_top : config.crop_top + config.crop_height,
            config.crop_left : config.crop_left + config.crop_width,
        ]
    if config.use_scaling:
        sw, sh = config.resolve_scale(out.shape[1], out.shape[0])
        out = _rescale(out, sw, sh)
    if config.flip:
        out = out.flip(0)
    return out.contiguous()


FIX = 16   # fractional bits of the rescaler's positions and weights


def _rescale(img, sw: int, sh: int):
    """(h, w, C) uint8 → (sh, sw, C) uint8: separable bilinear
    interpolation with 16-bit fixed-point positions and weights, in int64
    on the tensor's device."""
    h, w = img.shape[:2]
    dev = img.device
    one = 1 << FIX
    xs = (torch.arange(sw, dtype=torch.int64, device=dev) * w << FIX) // sw
    ys = (torch.arange(sh, dtype=torch.int64, device=dev) * h << FIX) // sh
    x0 = (xs >> FIX).clamp_max(w - 1)
    y0 = (ys >> FIX).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    fx = (xs & (one - 1))[None, :, None]
    fy = (ys & (one - 1))[:, None, None]
    src = img.to(torch.int64)
    top = src[y0][:, x0] * (one - fx) + src[y0][:, x1] * fx
    bot = src[y1][:, x0] * (one - fx) + src[y1][:, x1] * fx
    mix = (top * (one - fy) + bot * fy) >> (2 * FIX)
    return mix.clamp(0, 255).to(torch.uint8)


__all__ = ["DecoderConfig", "apply_output_options"]
