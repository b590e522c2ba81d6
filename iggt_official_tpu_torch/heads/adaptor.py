"""Token-pyramid projectors feeding the instance (part) head, channels-last.

Counterpart of `iggt_official_tpu/heads/adaptor.py` (`Projects`,
`GeoProjector`, `SamProjector`): the patch tokens of four aggregator layers
through one shared fp32 LayerNorm and a 1x1 projection per level, then a
resize stack per level.  `SamProjector` computes in ``dtype`` (fp32, or bf16
as the fast mode) after the LayerNorm; `GeoProjector` in fp32.  BatchNorm is
inference-form (fp32 inside, returned in its input's dtype).  Module names
follow the reference checkpoint (`projects.<level>`,
`resize_layers.<level>[.<stage>]`, `input_proj`, `residual_conv`,
`output_proj`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.ops.conv import Conv2d, ConvTranspose2d, FrozenBatchNorm


class Projects(nn.Module):
    """1x1 conv+BN+ReLU -> residual (3x3 conv+BN+ReLU, 3x3 conv+BN) -> 1x1 conv."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = features
        self.input_proj = nn.Sequential(
            Conv2d(f, f, 1, bias=False, dtype=dtype), FrozenBatchNorm(f), nn.ReLU())
        self.residual_conv = nn.Sequential(
            Conv2d(f, f, 3, padding=1, bias=False, dtype=dtype), FrozenBatchNorm(f), nn.ReLU(),
            Conv2d(f, f, 3, padding=1, bias=False, dtype=dtype), FrozenBatchNorm(f))
        self.output_proj = Conv2d(f, f, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_proj(x)
        return self.output_proj(self.residual_conv(x) + x)


def _project_tokens(tokens: torch.Tensor, patch_start_idx: int, grid_hw: Tuple[int, int],
                    norm: LayerNorm, proj: nn.Module) -> torch.Tensor:
    """(B, S, P, C) tokens -> (B*S, ph, pw, C') patch map: the patch tokens
    through the fp32 LayerNorm, then the 1x1 projection."""
    x = tokens[:, :, patch_start_idx:]
    B, S = x.shape[0], x.shape[1]
    ph, pw = grid_hw
    x = norm(x.reshape(B * S, ph * pw, x.shape[-1]))
    return proj(x.reshape(B * S, ph, pw, -1))


class GeoProjector(nn.Module):
    """4-level {res2..res5} pyramid at 4x / 2x / 1x / 0.5x the patch grid,
    NHWC with batch B*S: ConvTranspose k4 s4, ConvTranspose k2 s2, the
    projection alone, Conv k3 s2 p1.  ``pos_embed`` is taken and read by
    nothing, as in the JAX package (the reference's sine maps are never
    consumed)."""

    def __init__(self, dim_in: int, patch_size: int = 14, pos_embed: bool = False,
                 intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23),
                 out_channels: Tuple[int, ...] = (256, 256, 256, 256)):
        super().__init__()
        self.patch_size = patch_size
        self.pos_embed = pos_embed
        self.intermediate_layer_idx = intermediate_layer_idx
        oc = out_channels
        self.norm = LayerNorm(dim_in, eps=1e-5)
        self.projects = nn.ModuleList(Conv2d(dim_in, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])

    def forward(self, tokens_list: Sequence[torch.Tensor], images_hw: Tuple[int, int],
                patch_start_idx: int) -> Dict[str, torch.Tensor]:
        grid = (images_hw[0] // self.patch_size, images_hw[1] // self.patch_size)
        return {f"res{i + 2}": self.resize_layers[i](_project_tokens(
                    tokens_list[layer_idx], patch_start_idx, grid, self.norm, self.projects[i]))
                for i, layer_idx in enumerate(self.intermediate_layer_idx)}


class SamProjector(nn.Module):
    """4-level {res1..res4} pyramid at 4x / 2x / 1x / 0.5x the patch grid,
    NHWC with batch B*S."""

    def __init__(self, dim_in: int, patch_size: int = 14,
                 intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23),
                 out_channels: Tuple[int, ...] = (256, 256, 256, 256),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.intermediate_layer_idx = intermediate_layer_idx
        oc = out_channels
        dt = dtype
        self.norm = LayerNorm(dim_in, eps=1e-5)
        self.projects = nn.ModuleList(Conv2d(dim_in, c, 1, dtype=dt) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.Sequential(  # two exact 2x upsamples, each refined
                ConvTranspose2d(oc[0], oc[0], 4, stride=2, padding=1, dtype=dt),
                Projects(oc[0], dt),
                ConvTranspose2d(oc[0], oc[0], 4, stride=2, padding=1, dtype=dt),
                Projects(oc[0], dt)),
            nn.Sequential(ConvTranspose2d(oc[1], oc[1], 2, stride=2, dtype=dt),
                          Projects(oc[1], dt)),
            nn.Sequential(nn.Identity(), Projects(oc[2], dt)),
            nn.Sequential(Conv2d(oc[3], oc[3], 3, stride=2, padding=1, dtype=dt),
                          Projects(oc[3], dt)),
        ])

    def forward(self, tokens_list: Sequence[torch.Tensor], images_hw: Tuple[int, int],
                patch_start_idx: int) -> List[torch.Tensor]:
        grid = (images_hw[0] // self.patch_size, images_hw[1] // self.patch_size)
        return [self.resize_layers[i](_project_tokens(
                    tokens_list[layer_idx], patch_start_idx, grid, self.norm, self.projects[i]))
                for i, layer_idx in enumerate(self.intermediate_layer_idx)]
