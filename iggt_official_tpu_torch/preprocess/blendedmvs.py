"""BlendedMVS conversion to the SceneDir layout.

Counterpart of `iggt_official_tpu/preprocess/blendedmvs.py`, copied, on the
port's own `data/cropping.py` and `data/scene_dataset.py::read_pfm`.
Parity target: `dataset_preprocess/preprocess_blendedMVS.py:25-137` —
parse the ``*_cam.txt`` (world2cam extrinsic + intrinsic), read the PFM
rendered depth, rescale image+depth to the working resolution (rescaling
the intrinsics accordingly), and write per-view color/depth/cam files.
Output here is this package's SceneDir layout (color/*.jpg, depth/*.npy,
cam/*.npz with K + c2w pose) consumed by `data.scene_dataset.SceneDirDataset`
instead of the reference's jpg/exr/npz triplet — same information, one
canonical layout for every converter.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from iggt_official_tpu_torch.data.cropping import rescale_image_depthmap
from iggt_official_tpu_torch.data.scene_dataset import read_pfm


def load_cam_txt(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a BlendedMVS ``*_cam.txt``: returns (K, R_c2w, t_c2w).

    File layout: ``extrinsic`` + 4x4 world2cam matrix, blank,
    ``intrinsic`` + 3x3 K (`preprocess_blendedMVS.py:85-97`).
    """
    with open(path) as f:
        rt = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float64)
        k = np.loadtxt(f, skiprows=2, max_rows=3, dtype=np.float64)
    if rt.shape != (4, 4) or k.shape != (3, 3):
        raise ValueError(f"malformed cam file {path}")
    c2w = np.linalg.inv(rt)
    return k, c2w[:3, :3], c2w[:3, 3]


def convert_view(
    root: str, name: str, out_dir: str,
    resolution: Tuple[int, int] = (512, 384),
) -> None:
    from PIL import Image

    k, r_c2w, t_c2w = load_cam_txt(
        os.path.join(root, "cams", name + "_cam.txt")
    )
    image = np.asarray(
        Image.open(
            os.path.join(root, "blended_images", name + ".jpg")
        ).convert("RGB")
    )
    depth = read_pfm(
        os.path.join(root, "rendered_depth_maps", name + ".pfm")
    ).astype(np.float32)

    image_out, depth_out, k_out = rescale_image_depthmap(
        image, depth, k, resolution
    )

    for sub in ("color", "depth", "cam"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    image_out.save(os.path.join(out_dir, "color", name + ".jpg"), quality=80)
    np.save(os.path.join(out_dir, "depth", name + ".npy"), depth_out)
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = r_c2w, t_c2w
    np.savez(
        os.path.join(out_dir, "cam", name + ".npz"),
        intrinsics=k_out, pose=pose,
    )


def convert_scene(
    scene_root: str, out_dir: str, resolution: Tuple[int, int] = (512, 384)
) -> int:
    """Convert one BlendedMVS sequence directory; returns #views."""
    cam_dir = os.path.join(scene_root, "cams")
    names = sorted(
        f[: -len("_cam.txt")]
        for f in os.listdir(cam_dir)
        if f.endswith("_cam.txt") and not f.startswith("pair")
    )
    for name in names:
        convert_view(scene_root, name, out_dir, resolution)
    return len(names)
