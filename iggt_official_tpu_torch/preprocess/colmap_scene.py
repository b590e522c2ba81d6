"""COLMAP sparse model -> SceneDir conversion.

Mirrors the role of `dataset_preprocess/preprocess_*.py` +
`read_write_model.py`: read a COLMAP reconstruction, emit the processed
layout the data loaders consume —

    out_dir/<seq>/color/XXXXXX.jpg
    out_dir/<seq>/depth/XXXXXX.png     (uint16 millimeters, optional)
    out_dir/<seq>/cam/XXXXXX.npz       (pose = 4x4 cam2world, intrinsics 3x3)

COLMAP stores world-to-camera (qvec, tvec); poses are inverted to
camera-to-world here, matching what the loaders expect
(`iggt/datasets/scannet.py` npz convention).

Counterpart of `iggt_official_tpu/preprocess/colmap_scene.py`, copied; the
16-bit depth PNG is written by PIL (cv2 in the JAX package), its pixels
equal to cv2's file on reading back.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.data.colmap import (
    Camera,
    qvec2rotmat,
    read_model,
)


def camera_to_intrinsics(cam: Camera) -> np.ndarray:
    """COLMAP camera params -> 3x3 pinhole K (fisheye models use fx/fy/cx/cy
    and ignore distortion, as the reference preprocessors do)."""
    p = cam.params
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL" or (
        cam.model == "SIMPLE_RADIAL_FISHEYE"
    ):
        f, cx, cy = p[0], p[1], p[2]
        fx = fy = f
    else:
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def convert_colmap_scene(
    model_dir: str,
    images_dir: str,
    out_dir: str,
    seq_name: str = "seq0000",
    depth_maps: Optional[Dict[str, np.ndarray]] = None,
    ext: str = ".bin",
) -> int:
    """Convert one COLMAP reconstruction; returns the number of frames."""
    cameras, images, _points = read_model(model_dir, ext=ext)

    seq_dir = os.path.join(out_dir, seq_name)
    color_dir = os.path.join(seq_dir, "color")
    cam_dir = os.path.join(seq_dir, "cam")
    os.makedirs(color_dir, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    depth_dir = os.path.join(seq_dir, "depth")
    if depth_maps is not None:
        os.makedirs(depth_dir, exist_ok=True)

    count = 0
    for i, image in enumerate(sorted(images.values(), key=lambda im: im.name)):
        src = os.path.join(images_dir, image.name)
        if not os.path.exists(src):
            continue
        stem = f"{i:06d}"
        dst_ext = os.path.splitext(image.name)[1] or ".jpg"
        shutil.copy(src, os.path.join(color_dir, stem + dst_ext))

        # w2c -> c2w
        R = qvec2rotmat(image.qvec)
        t = np.asarray(image.tvec)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        K = camera_to_intrinsics(cameras[image.camera_id])
        np.savez(
            os.path.join(cam_dir, stem + ".npz"), pose=c2w, intrinsics=K
        )

        if depth_maps is not None and image.name in depth_maps:
            depth_mm = np.clip(
                depth_maps[image.name] * 1000.0, 0, 65535
            ).astype(np.uint16)
            PIL.Image.fromarray(depth_mm).save(
                os.path.join(depth_dir, stem + ".png")
            )
        count += 1
    return count
