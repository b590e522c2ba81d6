"""Camera pose decode: 9-D absT_quaR_FoV encoding -> (extrinsic, intrinsic).

Counterpart of `iggt_official_tpu/geometry/pose_enc.py`'s decoder.  Layout:
[:3] translation, [3:7] XYZW quaternion, [7] fov_h, [8] fov_w.  Extrinsics
are OpenCV world->camera [R|t] (..., 3, 4); intrinsics are in pixels with
the principal point at the image center.
"""

from __future__ import annotations

from typing import Tuple

import torch

from iggt_official_tpu_torch.geometry.rotation import quat_to_mat


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
