"""SAM2 image and coordinate transforms, mask post-processing (counterpart of
`iggt_official_tpu/sam2/transforms.py`, `sam2/utils/transforms.py:9-120`).

`SAM2Transforms`: square resize to the model resolution (PIL bilinear) with
ImageNet normalization, prompt coordinate rescaling, and
`postprocess_masks`, which runs on the masks' device: hole filling and
small-spark removal through `ops/connected_components.py` (when their areas
are set), then the align-corners bilinear resize back to the image's size.
`ResizeLongestSide`: SAM-v1's aspect-preserving resize (numpy / PIL).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from iggt_official_tpu_torch.ops.connected_components import fill_small_components
from iggt_official_tpu_torch.ops.interpolate import bilinear_resize_align_corners

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


class SAM2Transforms:
    def __init__(self, resolution: int, mask_threshold: float, max_hole_area: float = 0.0,
                 max_sprinkle_area: float = 0.0):
        self.resolution = resolution
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8 (or float in [0, 1]) image -> (res, res, 3) normalized float32."""
        from PIL import Image

        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        img = Image.fromarray(image).resize((self.resolution, self.resolution),
                                            Image.Resampling.BILINEAR)
        return (np.asarray(img, np.float32) / 255.0 - _MEAN) / _STD

    def forward_batch(self, images: Sequence[np.ndarray]) -> np.ndarray:
        return np.stack([self(im) for im in images])

    def transform_coords(self, coords: np.ndarray, normalize: bool = False,
                         orig_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        coords = np.asarray(coords, np.float32).copy()
        if normalize:
            h, w = orig_hw
            coords[..., 0] = coords[..., 0] / w
            coords[..., 1] = coords[..., 1] / h
        return coords * self.resolution

    def transform_boxes(self, boxes: np.ndarray, normalize: bool = False,
                        orig_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
        return self.transform_coords(np.asarray(boxes).reshape(-1, 2, 2), normalize, orig_hw)

    @torch.no_grad()
    def postprocess_masks(self, masks: torch.Tensor, orig_hw: Tuple[int, int]) -> torch.Tensor:
        """(B, M, H, W) mask logits -> (B, M, oh, ow) on the same device."""
        B, M = masks.shape[:2]
        flat = masks.float().reshape((B * M,) + tuple(masks.shape[2:]))
        t = self.mask_threshold
        if self.max_hole_area > 0:
            flat = fill_small_components(flat, flat <= t, self.max_hole_area, t + 10.0)
        if self.max_sprinkle_area > 0:
            flat = fill_small_components(flat, flat > t, self.max_sprinkle_area, t - 10.0)
        out = bilinear_resize_align_corners(flat[..., None], tuple(orig_hw))[..., 0]
        return out.reshape((B, M) + tuple(orig_hw))


class ResizeLongestSide:
    """Resize so the longest side is ``target_length``, and rescale point / box
    prompts to match (`utils/sam_utils/transforms.py:16-99`)."""

    def __init__(self, target_length: int):
        self.target_length = int(target_length)

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> Tuple[int, int]:
        scale = long_side_length / max(oldh, oldw)
        return int(oldh * scale + 0.5), int(oldw * scale + 0.5)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        from PIL import Image

        h, w = image.shape[:2]
        nh, nw = self.get_preprocess_shape(h, w, self.target_length)
        return np.asarray(Image.fromarray(image).resize((nw, nh), Image.BILINEAR))

    def apply_coords(self, coords: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        oldh, oldw = original_size
        nh, nw = self.get_preprocess_shape(oldh, oldw, self.target_length)
        coords = np.asarray(coords, np.float64).copy()
        coords[..., 0] *= nw / oldw
        coords[..., 1] *= nh / oldh
        return coords

    def apply_boxes(self, boxes: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        return self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2), original_size).reshape(-1, 4)
