"""Output activations for pose and dense heads (channels-last).

Counterpart of `iggt_official_tpu/heads/act.py`.
"""

from __future__ import annotations

from typing import Tuple

import torch


def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    """sign(y) * expm1(|y|)."""
    return torch.sign(y) * torch.expm1(torch.abs(y))


def base_pose_act(pose_enc: torch.Tensor, act_type: str = "linear") -> torch.Tensor:
    if act_type == "linear":
        return pose_enc
    if act_type == "inv_log":
        return inverse_log_transform(pose_enc)
    if act_type == "exp":
        return torch.exp(pose_enc)
    if act_type == "relu":
        return torch.relu(pose_enc)
    raise ValueError(f"Unknown act_type: {act_type}")


def activate_pose(pred_pose_enc: torch.Tensor, trans_act: str = "linear",
                  quat_act: str = "linear", fl_act: str = "linear") -> torch.Tensor:
    """Per-component activation of the 9-D pose encoding."""
    T = base_pose_act(pred_pose_enc[..., :3], trans_act)
    quat = base_pose_act(pred_pose_enc[..., 3:7], quat_act)
    fl = base_pose_act(pred_pose_enc[..., 7:], fl_act)
    return torch.cat([T, quat, fl], dim=-1)


def activate_head(fmap: torch.Tensor, activation: str = "norm_exp",
                  conf_activation: str = "expp1") -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a (B, H, W, C) map into activated values + confidence (last channel)."""
    xyz = fmap[..., :-1]
    conf = fmap[..., -1]

    if activation == "norm_exp":
        d = torch.clamp(torch.linalg.norm(xyz, dim=-1, keepdim=True), min=1e-8)
        pts3d = xyz / d * torch.expm1(d)
    elif activation == "norm":
        pts3d = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    elif activation == "exp":
        pts3d = torch.exp(xyz)
    elif activation == "relu":
        pts3d = torch.relu(xyz)
    elif activation == "inv_log":
        pts3d = inverse_log_transform(xyz)
    elif activation == "xy_inv_log":
        xy, z = xyz[..., :2], xyz[..., 2:3]
        z = inverse_log_transform(z)
        pts3d = torch.cat([xy * z, z], dim=-1)
    elif activation == "sigmoid":
        pts3d = torch.sigmoid(xyz)
    elif activation == "linear":
        pts3d = xyz
    else:
        raise ValueError(f"Unknown activation: {activation}")

    if conf_activation == "expp1":
        conf_out = 1 + torch.exp(conf)
    elif conf_activation == "expp0":
        conf_out = torch.exp(conf)
    elif conf_activation == "sigmoid":
        conf_out = torch.sigmoid(conf)
    else:
        raise ValueError(f"Unknown conf_activation: {conf_activation}")
    return pts3d, conf_out
