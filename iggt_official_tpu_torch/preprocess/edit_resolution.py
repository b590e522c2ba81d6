"""Rescale COLMAP camera intrinsics to a scene's actual image resolution.

Counterpart of `iggt_official_tpu/preprocess/edit_resolution.py`, copied.
Behavioural parity: `dataset_preprocess/edit_image_resolution.py:1-145` —
when a scene's images were downscaled (e.g. DL3DV `images_8/`), the sparse
model's `cameras.bin` still carries the original resolution; this tool
backs the file up once and scales width/height + focal/principal-point
params to match the first image on disk.  Idempotent: skipped when the
`.backup` already exists.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Dict, Optional, Tuple

from iggt_official_tpu_torch.data.colmap import (
    Camera,
    read_cameras_binary,
    write_cameras_binary,
)

# param layout per model: indices scaled by width vs height
# (fx-like by sw, fy-like by sh, cx by sw, cy by sh)
_SCALE_RULES = {
    "PINHOLE": (("w", "h", "w", "h"), 4),
    "SIMPLE_PINHOLE": (("w", "w", "h"), 3),   # f, cx, cy (f scaled by sw
    # like the reference, `edit_image_resolution.py:87-90`)
    "OPENCV": (("w", "h", "w", "h"), 8),      # distortion left untouched
}


def scale_camera(cam: Camera, new_w: int, new_h: int) -> Camera:
    sw = new_w / cam.width
    sh = new_h / cam.height
    name = cam.model
    rule = _SCALE_RULES.get(name)
    params = list(cam.params)
    if rule is None:
        print(f"warning: unsupported camera model {name}; params not scaled")
    else:
        axes, n = rule
        for i, axis in enumerate(axes[: min(len(axes), len(params))]):
            params[i] *= sw if axis == "w" else sh
    return cam._replace(width=new_w, height=new_h, params=params)


def first_image_size(images_dir: str) -> Optional[Tuple[int, int]]:
    import PIL.Image

    for p in sorted(glob.glob(os.path.join(images_dir, "*"))):
        try:
            with PIL.Image.open(p) as img:
                return img.width, img.height
        except Exception:
            continue
    return None


def edit_scene_resolution(
    scene_dir: str,
    sparse_rel: str = os.path.join("colmap", "sparse", "0"),
    images_rel: str = "images_8",
) -> bool:
    """Returns True if the cameras file was rescaled (False = skipped)."""
    camera_path = os.path.join(scene_dir, sparse_rel, "cameras.bin")
    backup_path = camera_path + ".backup"
    if os.path.exists(backup_path):
        print(f"{backup_path} exists; skipping")
        return False

    size = first_image_size(os.path.join(scene_dir, images_rel))
    if size is None:
        raise FileNotFoundError(
            f"no readable images under {scene_dir}/{images_rel}"
        )
    new_w, new_h = size

    cameras: Dict[int, Camera] = read_cameras_binary(camera_path)
    shutil.copy(camera_path, backup_path)
    scaled = {
        cid: scale_camera(cam, new_w, new_h) for cid, cam in cameras.items()
    }
    write_cameras_binary(scaled, camera_path)
    print(f"rescaled {len(scaled)} cameras to {new_w}x{new_h}")
    return True


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="root path to scenes")
    ap.add_argument("--scene", required=True, help="scene id")
    ap.add_argument("--images_rel", default="images_8")
    args = ap.parse_args()
    edit_scene_resolution(
        os.path.join(args.root, args.scene), images_rel=args.images_rel
    )


if __name__ == "__main__":
    main()
