"""Aria Synthetic Environments (ASE) conversion math.

Counterpart of `iggt_official_tpu/preprocess/ase.py`, copied.
Parity target: `dataset_preprocess/preprocess_ase.py:53-170`.  The full
export depends on `projectaria_tools` (fisheye rectification + device
calibration), which is an external dependency — the geometric cores are
first-party here and `aria_export_to_scannet` raises a clear error when
the toolkit is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def distance_to_depth(
    K: np.ndarray, dist: np.ndarray, uv: Optional[np.ndarray] = None
) -> np.ndarray:
    """Convert a ray-distance map to planar z-depth
    (`preprocess_ase.py:93-113`): z = dist / ||K^-1 [u v 1]||."""
    dist = np.asarray(dist)
    if uv is None and dist.ndim >= 2:
        uv = np.stack(
            np.meshgrid(np.arange(dist.shape[1]), np.arange(dist.shape[0])),
            -1,
        ).reshape(-1, 2)
        shape = dist.shape
        dist = dist.reshape(-1)
    else:
        shape = None
    uvh = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1)
    rays = (np.linalg.inv(K) @ uvh.T).T
    z = dist / np.linalg.norm(rays, axis=1)
    return z.reshape(shape) if shape is not None else z


def transform_3d_points(
    transform: np.ndarray, points: np.ndarray
) -> np.ndarray:
    """Apply a 4x4 to (N, 3) points (`preprocess_ase.py:115-121`)."""
    ph = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    return (transform @ ph.T).T[:, :3]


def unproject(
    K: np.ndarray, depth: np.ndarray, rgb: Optional[np.ndarray] = None
):
    """Depth map -> camera-space point cloud (+ colors)
    (`preprocess_ase.py:53-91`, vectorised)."""
    H, W = depth.shape
    uv = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    uvh = np.concatenate([uv, np.ones((len(uv), 1))], axis=-1)
    rays = (np.linalg.inv(K) @ uvh.T).T
    rays = rays / rays[:, 2:3]
    pts = rays * depth.reshape(-1, 1)
    valid = depth.reshape(-1) > 0
    if rgb is not None:
        return pts[valid], rgb.reshape(-1, rgb.shape[-1])[valid]
    return pts[valid]


def aria_export_to_scannet(scene_dir: str, out_dir: str) -> None:
    try:
        import projectaria_tools  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "ASE export needs projectaria_tools for fisheye rectification; "
            "install it or pre-rectify the capture externally"
        ) from e
    raise NotImplementedError(
        "rectification pipeline not bundled; see preprocess_ase.py in the "
        "upstream reference for the projectaria-based flow"
    )
