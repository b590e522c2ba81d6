"""ARKitScenes (lowres-wide) conversion helpers.

Parity target: `dataset_preprocess/preprocess_arkitscenes.py:25-352`:
trajectory parsing (axis-angle world2device rows -> cam2world mats),
nearest-timestamp frame matching, ``.pincam`` intrinsics, and the
sky-direction detection that rotates every camera so the world up axis
points up in the image.  scipy Rotation replaces cv2.Rodrigues +
numpy-quaternion.

Counterpart of `iggt_official_tpu/preprocess/arkitscenes.py`, copied, with
scipy taken inside `_rotvec_to_matrix` instead of at import.
"""

from __future__ import annotations

import os
from bisect import bisect_left
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _rotvec_to_matrix(rotvec) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rotvec).as_matrix()


def closest(value: float, sorted_list: Sequence[float]) -> float:
    """Nearest element of a sorted list (`preprocess_arkitscenes.py:30-42`)."""
    index = bisect_left(sorted_list, value)
    if index == 0:
        return sorted_list[0]
    if index == len(sorted_list):
        return sorted_list[-1]
    before, after = sorted_list[index - 1], sorted_list[index]
    return after if after - value < value - before else before


def read_traj(traj_path: str) -> Tuple[List[float], List[np.ndarray]]:
    """Parse a lowres_wide.traj file: rows of
    ``timestamp rx ry rz tx ty tz`` (world->device axis-angle) —
    returns (timestamps rounded to ms, cam2world 4x4 mats)
    (`preprocess_arkitscenes.py:53-84`)."""
    timestamps, poses_c2w = [], []
    with open(traj_path) as f:
        for line in f:
            tokens = line.split()
            if len(tokens) != 7:
                continue
            timestamps.append(round(float(tokens[0]), 3))
            w2c = np.eye(4)
            w2c[:3, :3] = _rotvec_to_matrix([float(t) for t in tokens[1:4]])
            w2c[:3, 3] = [float(t) for t in tokens[4:7]]
            poses_c2w.append(np.linalg.inv(w2c))
    return timestamps, poses_c2w


def read_pincam(path: str) -> np.ndarray:
    """``w h fx fy cx cy`` single-line pinhole file -> 3x3 K
    (`preprocess_arkitscenes.py:289-299`)."""
    w, h, fx, fy, cx, cy = np.loadtxt(path)
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def find_scene_orientation(
    poses_cam_to_world: Sequence[np.ndarray],
) -> Tuple[str, np.ndarray]:
    """Detect the sky direction from the average device up/right vectors
    and return (label, rotated_to_cam 4x4) so that
    ``pose @ rotated_to_cam`` makes world-up point up in the image
    (`preprocess_arkitscenes.py:305-344`)."""
    if len(poses_cam_to_world):
        up = sum(
            p @ np.array([0.0, -1.0, 0.0, 0.0]) for p in poses_cam_to_world
        ) / len(poses_cam_to_world)
        right = sum(
            p @ np.array([1.0, 0.0, 0.0, 0.0]) for p in poses_cam_to_world
        ) / len(poses_cam_to_world)
    else:
        up = np.array([0.0, -1.0, 0.0, 0.0])
        right = np.array([1.0, 0.0, 0.0, 0.0])
    up_world = np.array([0.0, 0.0, 1.0, 0.0])

    ang_up = np.degrees(np.arccos(np.clip(up_world @ up, -1, 1)))
    ang_right = np.degrees(np.arccos(np.clip(up_world @ right, -1, 1)))

    if abs(ang_up - 90.0) < abs(ang_right - 90.0):
        if ang_right > 90.0:
            label, rotvec = "LEFT", [0.0, 0.0, np.pi / 2]
        else:
            label, rotvec = "RIGHT", [0.0, 0.0, -np.pi / 2]
    else:
        if ang_up > 90.0:
            label, rotvec = "DOWN", [0.0, 0.0, np.pi]
        else:
            label, rotvec = "UP", [0.0, 0.0, 0.0]
    cam_to_rotated = np.eye(4)
    cam_to_rotated[:3, :3] = _rotvec_to_matrix(rotvec)
    return label, np.linalg.inv(cam_to_rotated)


def convert_scene(
    scene_dir: str, out_dir: str, max_views: int = 0
) -> Dict[str, int]:
    """Convert one ARKitScenes lowres-wide capture into SceneDir layout.

    Expects ``lowres_wide/`` (rgb ``<scene>_<ts>.png``), ``lowres_depth/``
    (mm uint16 png), ``lowres_wide_intrinsics/`` (.pincam) and
    ``lowres_wide.traj`` under ``scene_dir``.
    """
    from PIL import Image

    sid = os.path.basename(scene_dir.rstrip(os.sep))
    timestamps, poses = read_traj(
        os.path.join(scene_dir, "lowres_wide.traj")
    )
    label, rotated_to_cam = find_scene_orientation(poses)
    by_ts = dict(zip(timestamps, poses))
    ts_sorted = sorted(by_ts)

    rgb_dir = os.path.join(scene_dir, "lowres_wide")
    frames = sorted(os.listdir(rgb_dir))
    if max_views:
        frames = frames[:max_views]
    for sub in ("color", "depth", "cam"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    n = 0
    for fname in frames:
        stem = os.path.splitext(fname)[0]
        ts = round(float(stem.split("_")[-1]), 3)
        pose = by_ts[closest(ts, ts_sorted)] @ rotated_to_cam
        k = read_pincam(
            os.path.join(
                scene_dir, "lowres_wide_intrinsics", stem + ".pincam"
            )
        )
        img = Image.open(os.path.join(rgb_dir, fname)).convert("RGB")
        depth_mm = np.asarray(
            Image.open(os.path.join(scene_dir, "lowres_depth", fname))
        )
        img.save(os.path.join(out_dir, "color", f"{n:06d}.jpg"), quality=90)
        np.save(
            os.path.join(out_dir, "depth", f"{n:06d}.npy"),
            depth_mm.astype(np.float32) / 1000.0,
        )
        np.savez(
            os.path.join(out_dir, "cam", f"{n:06d}.npz"),
            intrinsics=k, pose=pose,
        )
        n += 1
    return {"scene": sid, "views": n, "sky_direction": label}
