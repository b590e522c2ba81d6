"""Quaternion -> rotation matrix, XYZW (scalar-last) convention.

Counterpart of `iggt_official_tpu/geometry/rotation.py::quat_to_mat` (the
pose decode's half; the encoder comes with the slices that need it);
broadcasts over leading dims.
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
