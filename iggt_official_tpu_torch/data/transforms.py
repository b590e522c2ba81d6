"""Image transforms for the data layer.

Counterpart of `iggt_official_tpu/data/transforms.py`, copied:
- `ImgNorm`: HWC float32 in [0, 1];
- `ColorJitter`: brightness / contrast / saturation / hue jitter with the
  torch parameter conventions, on PIL images.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import PIL.Image
import PIL.ImageEnhance


def ImgNorm(image) -> np.ndarray:
    """PIL/array -> HWC float32 in [0, 1]."""
    return np.asarray(image, np.float32) / 255.0


def _rand_factor(rng, span: Union[float, Tuple[float, float]], center=1.0):
    if isinstance(span, (tuple, list)):
        lo, hi = span
    else:
        lo, hi = max(0.0, center - span), center + span
    return rng.uniform(lo, hi)


class ColorJitter:
    """torchvision-style ColorJitter on PIL images
    (`transforms.py:11-28` uses tvf.ColorJitter(0.5, 0.5, 0.5, 0.1))."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1,
                 seed: Optional[int] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: PIL.Image.Image) -> PIL.Image.Image:
        ops = []
        if self.brightness:
            f = _rand_factor(self.rng, self.brightness)
            ops.append(lambda im: PIL.ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f = _rand_factor(self.rng, self.contrast)
            ops.append(lambda im: PIL.ImageEnhance.Contrast(im).enhance(f))
        if self.saturation:
            f = _rand_factor(self.rng, self.saturation)
            ops.append(lambda im: PIL.ImageEnhance.Color(im).enhance(f))
        if self.hue:
            h = self.rng.uniform(-self.hue, self.hue)

            def hue_shift(im, h=h):
                hsv = np.asarray(im.convert("HSV"), np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
                return PIL.Image.fromarray(
                    hsv.astype(np.uint8), "HSV"
                ).convert("RGB")

            ops.append(hue_shift)
        self.rng.shuffle(ops)
        for op in ops:
            image = op(image)
        return image
