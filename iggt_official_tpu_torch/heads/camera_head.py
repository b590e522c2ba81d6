"""Iterative camera-pose regression head (fp32).

Counterpart of `iggt_official_tpu/heads/camera_head.py`: the camera tokens of
the last aggregated layer go through ``num_iterations`` rounds of DiT-style
AdaLN modulation, a 4-block trunk and an MLP delta on the 9-D absT_quaR_FoV
encoding.  The trunk blocks attend over the S frame tokens with plain
matmul-softmax attention, as the JAX package does (`sdpa_xla`).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from iggt_official_tpu_torch.config import CameraHeadConfig
from iggt_official_tpu_torch.heads.act import activate_pose
from iggt_official_tpu_torch.layers.blocks import Block, LayerNorm, Linear, Mlp


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale) + shift


class CameraHead(nn.Module):
    """Per-frame 9-D camera encodings by iterative refinement."""

    def __init__(self, cfg: CameraHeadConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim_in
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, cfg.target_dim))
        self.trunk = nn.Sequential(*[
            Block(D, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, init_values=cfg.init_values)
            for _ in range(cfg.trunk_depth)
        ])
        self.token_norm = LayerNorm(D, eps=1e-5)
        self.trunk_norm = LayerNorm(D, eps=1e-5)
        self.embed_pose = Linear(cfg.target_dim, D)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), Linear(D, 3 * D))
        self.pose_branch = Mlp(D, D // 2, out_features=cfg.target_dim)
        self.adaln_norm = LayerNorm(D, eps=1e-6, affine=False)

    def forward(self, tokens: torch.Tensor) -> List[torch.Tensor]:
        """tokens: last aggregated layer (B, S, P, C) -> ``num_iterations``
        activated pose encodings, each (B, S, 9)."""
        cfg = self.cfg
        pose_tokens = self.token_norm(tokens[:, :, 0].float())
        B, S, _ = pose_tokens.shape
        pred = None
        out: List[torch.Tensor] = []
        for _ in range(cfg.num_iterations):
            if pred is None:
                module_input = self.embed_pose(
                    self.empty_pose_tokens.expand(B, S, cfg.target_dim))
            else:
                module_input = self.embed_pose(pred.detach())
            shift, scale, gate = self.poseLN_modulation(module_input).chunk(3, dim=-1)
            x = gate * modulate(self.adaln_norm(pose_tokens), shift, scale)
            x = self.trunk(x + pose_tokens)
            delta = self.pose_branch(self.trunk_norm(x))
            pred = delta if pred is None else pred + delta
            out.append(activate_pose(pred, trans_act=cfg.trans_act,
                                     quat_act=cfg.quat_act, fl_act=cfg.fl_act))
        return out
