"""Joint image/depth crop + rescale with intrinsics updates.

Counterpart of `iggt_official_tpu/data/cropping.py` (the reference's
`datasets/utils/cropping.py:57-185` and the COLMAP pixel-center offset
round-trip of its camera matrices), copied, except that the depth map's
nearest-neighbour resize is numpy with OpenCV's ``INTER_NEAREST`` rule
(`resize_nearest`) instead of ``cv2.resize``: the card machine has no cv2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import PIL.Image

LANCZOS = PIL.Image.Resampling.LANCZOS
BICUBIC = PIL.Image.Resampling.BICUBIC


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def _as_pil(image) -> PIL.Image.Image:
    if isinstance(image, PIL.Image.Image):
        return image
    return PIL.Image.fromarray(image)


def _nearest_index(src_len: int, dst_len: int) -> np.ndarray:
    """OpenCV's ``resizeNN`` source index for each output index: with the
    scale inv = dst / src in float64, src = min(floor(dst_i * (1 / inv)),
    src_len - 1) (not PIL's pixel-centre rule)."""
    ifx = 1.0 / (dst_len / src_len)
    return np.minimum(np.floor(np.arange(dst_len) * ifx).astype(np.int64), src_len - 1)


def resize_nearest(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, size, interpolation=cv2.INTER_NEAREST)`` with
    ``size`` = (W, H), byte for byte."""
    H, W = image.shape[:2]
    out_w, out_h = int(size[0]), int(size[1])
    return np.ascontiguousarray(
        image[_nearest_index(H, out_h)][:, _nearest_index(W, out_w)])



def rescale_image_depthmap(
    image, depthmap: Optional[np.ndarray], camera_intrinsics: np.ndarray,
    output_resolution, force: bool = True,
):
    """Rescale so (W, H) >= output_resolution (`cropping.py:57-86`)."""
    image = _as_pil(image)
    input_resolution = np.array(image.size)
    output_resolution = np.array(output_resolution)
    if depthmap is not None:
        assert tuple(depthmap.shape[:2]) == image.size[::-1]

    scale_final = max(output_resolution / image.size) + 1e-8
    if scale_final >= 1 and not force:
        return image, depthmap, camera_intrinsics
    output_resolution = np.floor(input_resolution * scale_final).astype(int)

    image = image.resize(
        tuple(output_resolution),
        resample=LANCZOS if scale_final < 1 else BICUBIC,
    )
    if depthmap is not None:
        depthmap = resize_nearest(depthmap, tuple(output_resolution))

    camera_intrinsics = camera_matrix_of_crop(
        camera_intrinsics, input_resolution, output_resolution,
        scaling=scale_final,
    )
    return image, depthmap, camera_intrinsics


def center_crop_image_depthmap(
    image, depthmap: Optional[np.ndarray], camera_intrinsics: np.ndarray,
    crop_scale: float,
):
    """Center crop to a fraction of the extent (`cropping.py:88-143`)."""
    assert 0 < crop_scale <= 1
    image = _as_pil(image)
    input_resolution = np.array(image.size)
    output_resolution = np.floor(input_resolution * crop_scale).astype(int)
    margins = input_resolution - output_resolution
    offset = margins / 2
    l, t = offset.astype(int)
    r, b = l + output_resolution[0], t + output_resolution[1]
    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = camera_intrinsics.copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def camera_matrix_of_crop(
    input_camera_matrix: np.ndarray, input_resolution, output_resolution,
    scaling: float = 1, offset_factor: float = 0.5, offset=None,
) -> np.ndarray:
    """Scaled/offset camera matrix through the COLMAP pixel-center
    round-trip (`cropping.py:146-159`)."""
    margins = np.asarray(input_resolution) * scaling - output_resolution
    assert np.all(margins >= 0.0)
    if offset is None:
        offset = offset_factor * margins
    K = opencv_to_colmap_intrinsics(input_camera_matrix)
    K[:2, :] *= scaling
    K[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(K)


def crop_image_depthmap(
    image, depthmap: np.ndarray, camera_intrinsics: np.ndarray, crop_bbox,
    mask: Optional[np.ndarray] = None,
):
    """Crop a window, shifting the principal point (`cropping.py:162-177`)."""
    image = _as_pil(image)
    l, t, r, b = crop_bbox
    image = image.crop((l, t, r, b))
    depthmap = depthmap[t:b, l:r]
    if mask is not None:
        mask = mask[t:b, l:r]
    K = camera_intrinsics.copy()
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K, mask


def bbox_from_intrinsics_in_out(
    input_camera_matrix: np.ndarray, output_camera_matrix: np.ndarray,
    output_resolution,
) -> Tuple[int, int, int, int]:
    out_w, out_h = output_resolution
    l, t = np.int32(
        np.round(input_camera_matrix[:2, 2] - output_camera_matrix[:2, 2])
    )
    return (int(l), int(t), int(l) + out_w, int(t) + out_h)
