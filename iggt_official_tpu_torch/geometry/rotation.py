"""Quaternion <-> rotation matrix, XYZW (scalar-last) convention.

Counterpart of `iggt_official_tpu/geometry/rotation.py` (`iggt/utils/
rotation.py:14-138`, from PyTorch3D); broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def quat_to_mat(quaternions: torch.Tensor) -> torch.Tensor:
    """XYZW quaternions (..., 4) -> rotation matrices (..., 3, 3); the
    quaternion need not be normalized (a 2/|q|^2 factor normalizes)."""
    i, j, k, r = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) (`rotation.py:113-122`)."""
    return torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real (last) part is non-negative (`rotation.py:125-138`)."""
    return torch.where(quaternions[..., 3:4] < 0, -quaternions, quaternions)


def mat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> standardized XYZW quaternions (..., 4)
    (`rotation.py:47-110`): the quaternion scaled by each of r, i, j, k, and
    the best-conditioned candidate (largest |component|) kept."""
    if tuple(matrix.shape[-2:]) != (3, 3):
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    batch_dim = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(batch_dim + (9,)), -1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    # floor at 0.1: a candidate with a tiny q_abs is never picked
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = q_abs.argmax(-1)
    out = torch.take_along_dim(candidates, best[..., None, None], dim=-2)[..., 0, :]
    return standardize_quaternion(out[..., [1, 2, 3, 0]])     # rijk -> ijkr
