"""DPT dense-prediction head (depth / world points), channels-last.

Counterpart of `iggt_official_tpu/heads/dpt_head.py`: tokens of 4
intermediate layers -> LayerNorm -> 1x1 projection -> UV sincos pos-embed
(x0.1) -> per-level resize (4x, 2x, 1x, 0.5x) -> RefineNet fusion ->
upsample to full resolution -> output convs -> value / confidence split.
The decode path computes in ``dtype`` (fp32, or bf16 as the fast mode); the
token LayerNorm and the output activations stay fp32.  Module names follow the reference checkpoint (`projects`, `resize_layers`,
`scratch.*`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.config import DPTConfig
from iggt_official_tpu_torch.heads.act import activate_head
from iggt_official_tpu_torch.heads.embeds import create_uv_grid, position_grid_to_embed
from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.ops.conv import Conv2d, ConvTranspose2d
from iggt_official_tpu_torch.ops.interpolate import bilinear_resize_align_corners


def apply_uv_pos_embed(x: torch.Tensor, img_w: int, img_h: int,
                       ratio: float = 0.1) -> torch.Tensor:
    """Add a scaled UV sincos embedding to an NHWC map."""
    H, W, C = x.shape[-3:]
    grid = create_uv_grid(W, H, aspect_ratio=img_w / img_h, device=x.device)
    emb = position_grid_to_embed(grid, C) * ratio
    return x + emb.to(x.dtype)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the *activated* input as skip
    (the reference's in-place ReLU rewrites the skip tensor)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = torch.relu(x)
        return self.conv2(torch.relu(self.conv1(a))) + a


class FeatureFusionBlock(nn.Module):
    """out = out_conv(resize(resConfUnit2(x [+ resConfUnit1(res)]), size))."""

    def __init__(self, features: int, has_residual: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_conv = Conv2d(features, features, 1, dtype=dtype)
        self.resConfUnit1 = ResidualConvUnit(features, dtype) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(features, dtype)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.resConfUnit1 is not None:
            x = x + self.resConfUnit1(residual)
        x = self.resConfUnit2(x)
        if size is None:
            size = (2 * x.shape[-3], 2 * x.shape[-2])
        return self.out_conv(bilinear_resize_align_corners(x, size))


def make_fusion_scratch(in_channels: Sequence[int], features: int, output_dim: int,
                        dtype: torch.dtype = torch.float32) -> nn.Module:
    """The reference's `scratch` container: 4 level projections, 4 RefineNet
    fusion blocks and the output convs, all computing in ``dtype``."""
    scratch = nn.Module()
    for i, c in enumerate(in_channels):
        setattr(scratch, f"layer{i + 1}_rn",
                Conv2d(c, features, 3, padding=1, bias=False, dtype=dtype))
    for i in range(1, 5):
        setattr(scratch, f"refinenet{i}", FeatureFusionBlock(features, i != 4, dtype))
    scratch.output_conv1 = Conv2d(features, features // 2, 3, padding=1, dtype=dtype)
    scratch.output_conv2 = nn.Sequential(
        Conv2d(features // 2, 32, 3, padding=1, dtype=dtype), nn.ReLU(),
        Conv2d(32, output_dim, 1, dtype=dtype))
    return scratch


def fuse_pyramid(scratch: nn.Module, levels: Sequence[torch.Tensor]):
    """RefineNet top-down fusion; returns (out1, out2, out3, out4)."""
    rn = [getattr(scratch, f"layer{i + 1}_rn")(levels[i]) for i in range(4)]
    out4 = scratch.refinenet4(rn[3], size=rn[2].shape[1:3])
    out3 = scratch.refinenet3(out4, rn[2], size=rn[1].shape[1:3])
    out2 = scratch.refinenet2(out3, rn[1], size=rn[0].shape[1:3])
    out1 = scratch.refinenet1(out2, rn[0])
    return out1, out2, out3, out4


class DPTHead(nn.Module):
    """Aggregated tokens (list of (B, S, P, C)) -> dense NHWC predictions.

    Returns ``(preds (B,S,H,W,out-1), conf (B,S,H,W))``, plus the fusion
    pyramid ``(out2, out3, out4)`` (in ``dtype``) at batch B*S when
    ``use_point_feat``."""

    def __init__(self, cfg: DPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        oc = cfg.out_channels
        self.norm = LayerNorm(cfg.dim_in, eps=1e-5)
        self.projects = nn.ModuleList(Conv2d(cfg.dim_in, c, 1, dtype=dtype) for c in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, stride=4, dtype=dtype),
            ConvTranspose2d(oc[1], oc[1], 2, stride=2, dtype=dtype),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, stride=2, padding=1, dtype=dtype),
        ])
        self.scratch = make_fusion_scratch(oc, cfg.features, cfg.output_dim, dtype)

    def forward(self, tokens_list: Sequence[torch.Tensor], images_hw: Tuple[int, int],
                patch_start_idx: int):
        cfg = self.cfg
        H, W = images_hw
        p = cfg.patch_size
        ph, pw = H // p, W // p
        levels: List[torch.Tensor] = []
        for i, layer_idx in enumerate(cfg.intermediate_layer_idx):
            x = tokens_list[layer_idx][:, :, patch_start_idx:]
            B, S = x.shape[0], x.shape[1]
            x = self.norm(x.reshape(B * S, ph * pw, x.shape[-1])).reshape(B * S, ph, pw, -1)
            x = self.projects[i](x)
            if cfg.pos_embed:
                x = apply_uv_pos_embed(x, W, H)
            levels.append(self.resize_layers[i](x))

        out1, out2, out3, out4 = fuse_pyramid(self.scratch, levels)
        out = self.scratch.output_conv1(out1)
        out = bilinear_resize_align_corners(out, (ph * p, pw * p))
        if cfg.pos_embed:
            out = apply_uv_pos_embed(out, W, H)
        out = self.scratch.output_conv2(out)
        preds, conf = activate_head(out.float(), activation=cfg.activation,
                                    conf_activation=cfg.conf_activation)
        preds = preds.reshape(B, S, *preds.shape[1:])
        conf = conf.reshape(B, S, *conf.shape[1:])
        if cfg.use_point_feat:
            return preds, conf, (out2, out3, out4)
        return preds, conf
