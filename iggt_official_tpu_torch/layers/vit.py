"""DINOv2-style ViT used as the IGGT patch embedder.

Counterpart of `iggt_official_tpu/layers/vit.py`: cls + register tokens,
absolute pos-embed (interpolated when the patch grid differs from the
trained one), pre-norm blocks with layerscale (their pre-norms through the
fused LayerNorm kernel with ``fused_ln=True``), final LayerNorm; returns the
normalized patch tokens.  Images arrive NHWC.  The attention is fixed at
construction and may be replaced per call, as the JAX package takes it at
apply time.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from iggt_official_tpu_torch.config import ViTConfig
from iggt_official_tpu_torch.layers.blocks import Block, LayerNorm, sdpa_plain
from iggt_official_tpu_torch.ops.conv import Conv2d
from iggt_official_tpu_torch.ops.interpolate import resize_antialias_bicubic


class ConvPatchEmbed(nn.Module):
    """(B, H, W, 3) -> (B, H/p * W/p, D) via a p x p stride-p conv."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor, fused_ln: bool = False,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """``fused_ln`` and ``attn_fn`` are taken for DinoViT's signature;
        there is no norm and no attention here."""
        B, H, W, _ = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {(H, W)} is not a multiple of the patch size {p}")
        y = self.proj(x)
        return y.reshape(B, (H // p) * (W // p), y.shape[-1])


class DinoViT(nn.Module):
    """DINOv2 ViT returning normalized patch tokens (B, N, D)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 attn_fn: Callable = sdpa_plain):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        grid = cfg.img_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.embed_dim))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, cfg.embed_dim))
        self.patch_embed = ConvPatchEmbed(cfg.patch_size, cfg.embed_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                  init_values=cfg.init_values, qk_norm=False, dtype=dtype,
                  ln_eps=cfg.ln_eps, attn_fn=attn_fn)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)

    def forward(self, images: torch.Tensor, fused_ln: bool = False,
                attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """``attn_fn`` replaces the blocks' attention for one call (the
        training route)."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        p = cfg.patch_size
        x = self.patch_embed(images)
        D = x.shape[-1]
        x = torch.cat([self.cls_token.expand(B, 1, D).to(x.dtype), x], dim=1)
        x = x + self._interpolate_pos_encoding(H // p, W // p).to(x.dtype)
        if cfg.num_register_tokens:
            regs = self.register_tokens.expand(B, -1, -1).to(x.dtype)
            x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x, fused_ln=fused_ln, attn_fn=attn_fn)
        x = self.norm(x)
        return x[:, 1 + cfg.num_register_tokens:].to(self.dtype)

    def _interpolate_pos_encoding(self, h0: int, w0: int) -> torch.Tensor:
        """Antialiased-bicubic resize of the (grid x grid) patch pos-embed to
        (h0 x w0); the trained grid passes through unchanged."""
        grid = self.cfg.img_size // self.cfg.patch_size
        if h0 == grid and w0 == grid:
            return self.pos_embed
        cls_pe = self.pos_embed[:, :1].float()
        dim = self.pos_embed.shape[-1]
        patch_pe = self.pos_embed[:, 1:].float().reshape(grid, grid, dim)
        patch_pe = resize_antialias_bicubic(patch_pe, (h0, w0)).reshape(1, h0 * w0, dim)
        return torch.cat([cls_pe, patch_pe], dim=1)
