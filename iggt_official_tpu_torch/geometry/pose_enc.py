"""Camera pose codec: (extrinsic, intrinsic) <-> 9-D absT_quaR_FoV encoding.

Counterpart of `iggt_official_tpu/geometry/pose_enc.py`.  Layout:
[:3] translation, [3:7] XYZW quaternion, [7] fov_h, [8] fov_w.  Extrinsics
are OpenCV world->camera [R|t] (..., 3, 4); intrinsics are in pixels with
the principal point at the image center.
"""

from __future__ import annotations

from typing import Tuple

import torch

from iggt_official_tpu_torch.geometry.rotation import mat_to_quat, quat_to_mat


def extri_intri_to_pose_encoding(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                                 image_size_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 3, 4) + (..., 3, 3) -> (..., 9) fp32 (`pose_enc.py:11-63`)."""
    quat = mat_to_quat(extrinsics[..., :3, :3])
    H, W = image_size_hw
    fov_h = 2 * torch.atan((H / 2) / intrinsics[..., 1, 1])
    fov_w = 2 * torch.atan((W / 2) / intrinsics[..., 0, 0])
    return torch.cat([extrinsics[..., :3, 3], quat, fov_h[..., None], fov_w[..., None]],
                     dim=-1).float()


def pose_encoding_to_extri_intri(
    pose_encoding: torch.Tensor, image_size_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 9) -> ((..., 3, 4), (..., 3, 3))."""
    T = pose_encoding[..., :3]
    quat = pose_encoding[..., 3:7]
    fov_h = pose_encoding[..., 7]
    fov_w = pose_encoding[..., 8]
    extrinsics = torch.cat([quat_to_mat(quat), T[..., None]], dim=-1)
    H, W = image_size_hw
    fy = (H / 2.0) / torch.tan(fov_h / 2.0)
    fx = (W / 2.0) / torch.tan(fov_w / 2.0)
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, zeros, torch.full_like(fx, W / 2)], dim=-1)
    row1 = torch.stack([zeros, fy, torch.full_like(fy, H / 2)], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return extrinsics, torch.stack([row0, row1, row2], dim=-2)
