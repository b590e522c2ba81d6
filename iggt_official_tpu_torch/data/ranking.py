"""Covisibility ranking from camera extrinsics.

Counterpart of `iggt_official_tpu/data/ranking.py`, copied (numpy):
pairwise distance = normalized rotation geodesic (deg/180) + lambda_t *
camera-center L2 (after average-scale normalization), chunked for long
sequences; per-frame argsort ranking.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rotation_diff(R: np.ndarray, chunk: int = 0) -> np.ndarray:
    """All-pairs normalized rotation angle, (N, N) in [0, 1]."""
    N = len(R)
    Rt = R.transpose(0, 2, 1)
    if not chunk or N <= chunk:
        M = np.einsum("aij,bjk->abik", Rt, R)
        tr = np.trace(M, axis1=-2, axis2=-1)
        val = np.clip((tr - 1) / 2, -1.0, 1.0)
        return np.degrees(np.arccos(val)) / 180.0
    out = np.empty((N, N), np.float32)
    for i0 in range(0, N, chunk):
        i1 = min(N, i0 + chunk)
        M = np.einsum("aij,bjk->abik", Rt[i0:i1], R)
        tr = np.trace(M, axis1=-2, axis2=-1)
        out[i0:i1] = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1))) / 180
    return out


def compute_ranking(
    extrinsics: np.ndarray,
    lambda_t: float = 1.0,
    normalize: bool = True,
    chunk_threshold: int = 6000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (ranking (N, N) argsorted neighbours incl. self first,
    dists (N, N))."""
    extrinsics = np.asarray(extrinsics, np.float64)
    if normalize:
        extrinsics = extrinsics.copy()
        centers = extrinsics[:, :3, 3]
        avg_scale = np.mean(np.linalg.norm(centers, axis=1))
        if avg_scale > 0:
            extrinsics[:, :3, 3] = centers / avg_scale

    R = extrinsics[:, :3, :3]
    t = extrinsics[:, :3, 3]
    chunk = 1000 if len(extrinsics) > chunk_threshold else 0
    rot = _rotation_diff(R, chunk=chunk)
    trans = np.linalg.norm(t[:, None] - t[None, :], axis=2)
    dists = rot + lambda_t * trans
    ranking = np.argsort(dists, axis=1)
    return ranking, dists
