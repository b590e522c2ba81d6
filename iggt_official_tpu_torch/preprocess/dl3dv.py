"""DL3DV depth-map extraction from COLMAP dense stereo output.

Counterpart of `iggt_official_tpu/preprocess/dl3dv.py`, copied.
Parity target: `dataset_preprocess/dl3dv_depthmap.py:10-74` — read
``*.png.geometric.bin`` depth maps, clamp to [min_depth, depth_thre]
(zeros/negatives stay invalid->0), resize to the RGB resolution with
nearest-neighbour, save per-frame ``.npy``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from iggt_official_tpu_torch.preprocess.dense import read_colmap_array


def clamp_depth(
    depth: np.ndarray,
    min_depth: float = 0.0,
    max_depth: float = 500.0,
    size: Tuple[int, int] = None,  # (W, H)
) -> np.ndarray:
    """Resize (nearest) + clamp; invalid (<=0) pixels become 0
    (`dl3dv_depthmap.py:10-24`)."""
    depth = np.asarray(depth, np.float32)
    if size is not None:
        W, H = size
        yy = (np.arange(H) * depth.shape[0] / H).astype(np.int64)
        xx = (np.arange(W) * depth.shape[1] / W).astype(np.int64)
        depth = depth[yy[:, None], xx[None, :]]
    invalid = depth <= 0
    out = np.clip(depth, min_depth, max_depth)
    out[invalid] = 0.0
    return out.astype(np.float32)


def process_scene(
    scene_folder: str,
    depth_thre: float = 500.0,
    min_depth: float = 0.0,
    image_size: Tuple[int, int] = None,
) -> int:
    """Extract clamped npy depths for every geometric depth bin under
    ``<scene>/colmap/dense/stereo/depth_maps``; returns #frames."""
    depth_dir = os.path.join(
        scene_folder, "colmap", "dense", "stereo", "depth_maps"
    )
    out_dir = os.path.join(scene_folder, "depths")
    os.makedirs(out_dir, exist_ok=True)
    if image_size is None:
        from PIL import Image

        img_dir = os.path.join(scene_folder, "images_8")
        first = sorted(os.listdir(img_dir))[0]
        image_size = Image.open(os.path.join(img_dir, first)).size

    n = 0
    for fname in sorted(os.listdir(depth_dir)):
        if not fname.endswith(".png.geometric.bin"):
            continue
        path = os.path.join(depth_dir, fname)
        if os.path.getsize(path) == 0:
            continue
        depth = read_colmap_array(path)
        out = clamp_depth(depth, min_depth, depth_thre, image_size)
        np.save(
            os.path.join(
                out_dir, fname.replace(".png.geometric.bin", ".npy")
            ),
            out,
        )
        n += 1
    return n


def scale_colmap_cameras(cameras, new_width: int, new_height: int):
    """Rescale COLMAP camera intrinsics to a new resolution
    (`dataset_preprocess/edit_image_resolution.py:73-97`): fx/cx by the
    width ratio, fy/cy by the height ratio (SIMPLE_PINHOLE uses the width
    ratio for its single focal).  Returns a new {id: Camera} dict."""
    out = {}
    for cid, cam in cameras.items():
        sw = new_width / cam.width
        sh = new_height / cam.height
        params = np.asarray(cam.params, np.float64).copy()
        if cam.model == "PINHOLE":
            params[:4] *= [sw, sh, sw, sh]
        elif cam.model == "SIMPLE_PINHOLE":
            params[:3] *= [sw, sw, sh]
        elif cam.model == "OPENCV":
            params[:4] *= [sw, sh, sw, sh]
        else:
            raise ValueError(f"unsupported camera model {cam.model}")
        out[cid] = cam._replace(
            width=new_width, height=new_height, params=params
        )
    return out
