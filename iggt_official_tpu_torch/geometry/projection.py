"""Unprojection and SE3 utilities, vectorized over frames.

Counterpart of `iggt_official_tpu/geometry/projection.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def closed_form_inverse_se3(se3: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) or (..., 3, 4) SE3 matrices: [R|t]^-1 = [R^T | -R^T t];
    returns (..., 4, 4)."""
    if tuple(se3.shape[-2:]) not in ((4, 4), (3, 4)):
        raise ValueError(f"se3 must end in (4,4) or (3,4), got {tuple(se3.shape)}.")
    R = se3[..., :3, :3]
    T = se3[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -torch.matmul(Rt, T)], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=se3.dtype, device=se3.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def depth_to_cam_coords_points(depth_map: torch.Tensor,
                               intrinsic: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + intrinsics (..., 3, 3) -> camera coords (..., H, W, 3)."""
    H, W = depth_map.shape[-2:]
    fu = intrinsic[..., 0, 0][..., None, None]
    fv = intrinsic[..., 1, 1][..., None, None]
    cu = intrinsic[..., 0, 2][..., None, None]
    cv = intrinsic[..., 1, 2][..., None, None]
    v = torch.arange(H, dtype=depth_map.dtype, device=depth_map.device)[:, None]
    u = torch.arange(W, dtype=depth_map.dtype, device=depth_map.device)[None, :]
    x_cam = (u - cu) * depth_map / fu
    y_cam = (v - cv) * depth_map / fv
    return torch.stack([x_cam, y_cam, depth_map], dim=-1)


def depth_to_world_coords_points(
    depth_map: torch.Tensor, extrinsic: torch.Tensor, intrinsic: torch.Tensor,
    z_far: float = 100.0, eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth (..., H, W) -> (world points, camera points, valid mask);
    ``extrinsic`` (..., 3, 4) is camera-from-world."""
    point_mask = depth_map > eps
    if z_far > 0:
        point_mask = point_mask & (depth_map < z_far)
    cam_coords = depth_to_cam_coords_points(depth_map, intrinsic)
    cam_to_world = closed_form_inverse_se3(extrinsic)
    R = cam_to_world[..., :3, :3]
    t = cam_to_world[..., :3, 3]
    world = torch.einsum("...ij,...hwj->...hwi", R, cam_coords) + t[..., None, None, :]
    return world, cam_coords, point_mask


def unproject_depth_map_to_point_map(depth_map: torch.Tensor, extrinsics_cam: torch.Tensor,
                                     intrinsics_cam: torch.Tensor) -> torch.Tensor:
    """(S, H, W[, 1]) depth -> (S, H, W, 3) world points."""
    if depth_map.dim() == 4 and depth_map.shape[-1] == 1:
        depth_map = depth_map[..., 0]
    world, _, _ = depth_to_world_coords_points(depth_map, extrinsics_cam, intrinsics_cam)
    return world


def project_world_points_to_pixels(world_points: torch.Tensor, extrinsic: torch.Tensor,
                                   intrinsic: torch.Tensor, eps: float = 1e-8
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of the unprojection: world points (..., N, 3) and camera-from-
    world extrinsics (..., 3, 4) -> (pixel uv (..., N, 2), depth (..., N))."""
    R = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    cam = torch.einsum("...ij,...nj->...ni", R, world_points) + t[..., None, :]
    uvw = torch.einsum("...ij,...nj->...ni", intrinsic, cam)
    return uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=eps), cam[..., 2]
