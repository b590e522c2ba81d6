"""Hiera trunk and FPN image encoder (counterpart of `iggt_official_tpu/sam2/hiera.py`).

- `Hiera` (`sam2/modeling/backbones/hieradet.py:163-293`): 7x7 / stride 4
  conv patch embed, a background position embedding resized to the grid
  plus a tiled window embedding, then stages of `MultiScaleBlock`s with
  2x2 max-pooled queries at the stage boundaries and global attention at
  the configured blocks; returns each stage's map, fine to coarse.
- `ImageEncoder` (`backbones/image_encoder.py:8-128`): the FPN neck, 1x1
  lateral convs to d_model, nearest top-down fusion at the configured
  levels, sine position embeddings, ``scalp`` coarsest levels dropped.

Every attention goes through `attention` (`ops/flash_attention.py`): on the
card the fp32 flash kernel at head dim 72 (Hiera-L: 48 launches per image
at 1024 px), on the CPU its plain version.  The JAX package sends calls
under 4096 tokens to XLA's softmax for the TPU's reasons; here the windowed
calls take the kernel too.

The background position embedding is resized by align-corners bilinear
interpolation, as the JAX package does (upstream resizes it bicubically);
with a trained checkpoint the two differ.  All maps NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.ops.conv import Conv2d
from iggt_official_tpu_torch.ops.flash_attention import attention
from iggt_official_tpu_torch.ops.interpolate import bilinear_resize_align_corners
from iggt_official_tpu_torch.sam2.common import (
    MLP, PositionEmbeddingSine, gelu, window_partition, window_unpartition,
)
from iggt_official_tpu_torch.sam2.config import HieraConfig, SAM2Config


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 / stride 2 max-pool (odd edges dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """`hieradet.py:33-75`: multi-head attention over a window's tokens, the
    queries 2x2 max-pooled in a q-pool block."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        hd = self.dim_out // self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, hd)
        q, k, v = qkv.unbind(2)           # strided views, read in place by the kernel
        if self.q_pool:
            q = max_pool_2x2(q.reshape(B, H, W, self.dim_out))
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.num_heads, hd)
        out = attention(q, k, v)
        return self.proj(out.reshape(B, H, W, self.dim_out))


class MultiScaleBlock(nn.Module):
    """`hieradet.py:78-160`."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float = 4.0,
                 q_stride: Optional[Tuple[int, int]] = None, window_size: int = 0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.q_stride = q_stride
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool=q_stride is not None)
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, activation=gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = max_pool_2x2(shortcut)
        ws = self.window_size
        H, W = x.shape[1:3]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride and ws > 0:
            ws = ws // self.q_stride[0]
            H, W = shortcut.shape[1:3]
            pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, 7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Hiera(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim)
        bg_h, bg_w = cfg.window_pos_embed_bkg_spatial_size
        ws0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bg_h, bg_w))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, ws0, ws0))
        stage_ends = [sum(cfg.stages[: i + 1]) - 1 for i in range(len(cfg.stages))]
        q_pool_blocks = [e + 1 for e in stage_ends[:-1]][: cfg.q_pool]
        self.stage_ends = stage_ends
        blocks = []
        dim, heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
        for i in range(sum(cfg.stages)):
            dim_out = dim
            window_size = cfg.window_spec[cur_stage - 1]
            if cfg.global_att_blocks and i in cfg.global_att_blocks:
                window_size = 0
            if i - 1 in stage_ends:
                dim_out = int(dim * cfg.dim_mul)
                heads = int(heads * cfg.head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(
                dim, dim_out, heads,
                q_stride=cfg.q_stride if i in q_pool_blocks else None,
                window_size=window_size))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """images (B, H, W, 3) -> each stage's NHWC map, fine to coarse."""
        x = self.patch_embed(x)
        H, W = x.shape[1:3]
        ws0 = self.cfg.window_spec[0]
        pe = bilinear_resize_align_corners(self.pos_embed.permute(0, 2, 3, 1).float(), (H, W))
        tiled = self.pos_embed_window[0].permute(1, 2, 0).repeat(-(-H // ws0), -(-W // ws0), 1)
        x = x + (pe[0] + tiled[:H, :W]).to(x.dtype)
        outputs = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.stage_ends:
                outputs.append(x)
        return outputs


class ConvWrapper(nn.Module):
    """The neck's ``convs.<i>.conv`` (upstream wraps each 1x1 conv in a Sequential)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FpnNeck(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(ConvWrapper(c, cfg.d_model)
                                   for c in cfg.hiera.channel_list)   # coarse first
        self.position_encoding = PositionEmbeddingSine(cfg.d_model)

    def forward(self, feats: List[torch.Tensor]):
        n = len(feats) - 1
        out: List[Optional[torch.Tensor]] = [None] * len(feats)
        pos: List[Optional[torch.Tensor]] = [None] * len(feats)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](feats[i].float())
            if i in self.cfg.fpn_top_down_levels and prev is not None:
                h, w = lateral.shape[1:3]
                td = prev.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                prev = lateral + td[:, :h, :w]
            else:
                prev = lateral
            out[i] = prev
            pe = self.position_encoding(prev.shape[1], prev.shape[2], prev.device)
            pos[i] = pe[None].expand((prev.shape[0],) + pe.shape).to(prev.dtype)
        return out, pos


class ImageEncoder(nn.Module):
    """Hiera + FPN neck: ``{"vision_features", "vision_pos_enc", "backbone_fpn"}``."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg.hiera)
        self.neck = FpnNeck(cfg)

    def forward(self, images: torch.Tensor) -> Dict[str, object]:
        out, pos = self.neck(self.trunk(images))
        if self.cfg.scalp > 0:
            out, pos = out[: -self.cfg.scalp], pos[: -self.cfg.scalp]
        return {"vision_features": out[-1], "vision_pos_enc": pos, "backbone_fpn": out}
