"""Host image loading / preprocessing (copy of `iggt_official_tpu/utils/images.py`).

PIL load, RGBA composited onto white, three modes -- "crop" (width 518,
height center-cropped), "pad" (long side 518, short side padded with 1.0 to
square), "resize" (explicit W x H) -- bicubic resampling, and a
mixed-shape padding fallback.  Output is NHWC float32 in [0, 1], shape
(S, H, W, 3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

_DEFAULT_TARGET = 518


def load_and_preprocess_images(
    image_path_list: Sequence[str],
    mode: str = "crop",
    resize_target_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    if not image_path_list:
        raise ValueError("At least 1 image is required")
    if mode not in ("crop", "pad", "resize"):
        raise ValueError("Mode must be either 'crop', 'pad', or 'resize'")
    if mode == "resize" and not (
        isinstance(resize_target_size, (tuple, list)) and len(resize_target_size) == 2
    ):
        raise ValueError("resize_target_size must be a (width, height) tuple for mode='resize'")

    images: List[np.ndarray] = []
    shapes = set()
    for path in image_path_list:
        img = Image.open(path)
        if img.mode == "RGBA":
            background = Image.new("RGBA", img.size, (255, 255, 255, 255))
            img = Image.alpha_composite(background, img)
        img = img.convert("RGB")
        width, height = img.size

        if mode == "pad":
            if width >= height:
                new_w = _DEFAULT_TARGET
                new_h = round(height * (new_w / width) / 14) * 14
            else:
                new_h = _DEFAULT_TARGET
                new_w = round(width * (new_h / height) / 14) * 14
        elif mode == "resize":
            new_w, new_h = resize_target_size
        else:  # crop
            new_w = _DEFAULT_TARGET
            new_h = round(height * (new_w / width) / 14) * 14

        img = img.resize((new_w, new_h), Image.Resampling.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0

        if mode == "crop" and new_h > _DEFAULT_TARGET:
            y0 = (new_h - _DEFAULT_TARGET) // 2
            arr = arr[y0:y0 + _DEFAULT_TARGET]
        elif mode == "pad":
            arr = _pad_to(arr, _DEFAULT_TARGET, _DEFAULT_TARGET)

        shapes.add(arr.shape[:2])
        images.append(arr)

    if len(shapes) > 1:
        max_h = max(s[0] for s in shapes)
        max_w = max(s[1] for s in shapes)
        images = [_pad_to(a, max_h, max_w) for a in images]
    return np.stack(images)


def _pad_to(arr: np.ndarray, H: int, W: int) -> np.ndarray:
    """Center-pad with 1.0 (white)."""
    h_pad = H - arr.shape[0]
    w_pad = W - arr.shape[1]
    if h_pad <= 0 and w_pad <= 0:
        return arr
    top, left = h_pad // 2, w_pad // 2
    return np.pad(arr, ((top, h_pad - top), (left, w_pad - left), (0, 0)),
                  constant_values=1.0)
