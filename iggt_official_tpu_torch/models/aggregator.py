"""Alternating-attention Aggregator trunk.

Counterpart of `iggt_official_tpu/models/aggregator.py`: images
(B, S, H, W, 3) in [0, 1] -> 24 aggregated token maps (B, S, P, 2 * embed_dim)
(frame-attention output ++ global-attention output) and patch_start_idx = 5
(1 camera + 4 register tokens).  RoPE tables are computed once per forward
and reshaped between the frame view (B*S, P) and the global view (B, S*P).
Every block calls ``attn_fn`` (the kernel dispatcher: the flash kernel for
the DINOv2 blocks, the fused kernel for the frame and global blocks' q/k
prep, at any length).
With ``fused_ln=True`` every block's pre-norms (DINOv2, frame, global) go
through the fused LayerNorm kernel.  With ``global_merge_r > 0`` the global
blocks attend over merged keys and values (`ops/token_merge.py`): the plan is
computed once per forward on the trunk's input tokens in fp32, with view 0
and every view's camera and register tokens protected, ``r`` clamped to the
unprotected candidates (one view: no merge); the frame blocks are untouched.
``forward``'s ``attn_fn`` replaces the dispatcher for one call in the frame,
global and DINOv2 blocks (the training step passes `sdpa_plain`, as the JAX
step trains through `sdpa_xla`), and ``remat=True`` under grad recomputes
each frame and global block in the backward pass
(`torch.utils.checkpoint`), as the JAX package's ``nn.remat(Block)``; the
DINOv2 blocks are kept, as there.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from iggt_official_tpu_torch.config import AggregatorConfig
from iggt_official_tpu_torch.layers.blocks import Block
from iggt_official_tpu_torch.layers.rope import compute_rope_2d, make_patch_positions
from iggt_official_tpu_torch.layers.vit import ConvPatchEmbed, DinoViT
from iggt_official_tpu_torch.ops.flash_attention import attention
from iggt_official_tpu_torch.ops.token_merge import (
    compute_merge_plan,
    make_merged_attention,
    merge_count,
    protected_tokens,
)

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


def slice_expand_and_flatten(token: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(1, 2, X, C) special tokens -> (B*S, X, C): index 0 serves the first
    frame, index 1 every other frame."""
    query = token[:, 0:1].expand(B, 1, *token.shape[2:])
    others = token[:, 1:2].expand(B, S - 1, *token.shape[2:])
    return torch.cat([query, others], dim=1).reshape(B * S, *token.shape[2:])


class Aggregator(nn.Module):
    """Alternating frame/global attention over multi-view patch tokens."""

    def __init__(self, cfg: AggregatorConfig, dtype: torch.dtype = torch.float32,
                 attn_fn: Callable = attention):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        C = cfg.embed_dim
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, C))
        if "conv" in cfg.patch_embed:
            self.patch_embed = ConvPatchEmbed(cfg.patch_size, C, dtype=dtype)
        else:
            self.patch_embed = DinoViT(cfg.vit, dtype=dtype, attn_fn=attn_fn)

        def blocks(fn):
            return nn.ModuleList(
                Block(C, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                      proj_bias=cfg.proj_bias, ffn_bias=cfg.ffn_bias,
                      init_values=cfg.init_values, qk_norm=cfg.qk_norm, dtype=dtype,
                      attn_fn=fn)
                for _ in range(cfg.depth)
            )

        self.frame_blocks = blocks(attn_fn)
        self.global_blocks = blocks(attn_fn)

    def forward(self, images: torch.Tensor, fused_ln: bool = False,
                global_merge_r: int = 0, attn_fn: Optional[Callable] = None,
                remat: bool = False) -> Tuple[List[torch.Tensor], int]:
        cfg = self.cfg
        B, S, H, W, C_in = images.shape
        if C_in != 3:
            raise ValueError(f"Expected 3 input channels, got {C_in}")
        p = cfg.patch_size
        psi = cfg.patch_start_idx
        mean = torch.tensor(_RESNET_MEAN, dtype=torch.float32, device=images.device)
        std = torch.tensor(_RESNET_STD, dtype=torch.float32, device=images.device)
        x = ((images.float() - mean) / std).reshape(B * S, H, W, 3).to(self.dtype)
        patch_tokens = self.patch_embed(x, fused_ln=fused_ln, attn_fn=attn_fn)

        cam = slice_expand_and_flatten(self.camera_token, B, S).to(patch_tokens.dtype)
        reg = slice_expand_and_flatten(self.register_token, B, S).to(patch_tokens.dtype)
        tokens = torch.cat([cam, reg, patch_tokens], dim=1)
        P = tokens.shape[1]
        C = cfg.embed_dim

        rope_frame = rope_global = None
        if cfg.rope_freq > 0:
            positions = make_patch_positions(H // p, W // p, B * S, psi, device=images.device)
            rope_frame = compute_rope_2d(positions, C // cfg.num_heads, cfg.rope_freq)
            rope_global = rope_frame.map(lambda t: t.reshape(B, S * P, t.shape[-1]))

        merged_attn = None
        if global_merge_r > 0:
            protect = protected_tokens(S, P, psi)
            r = merge_count(global_merge_r, protect)
            if r > 0:
                protect_t = torch.from_numpy(protect).to(images.device).expand(B, S * P)
                plan = compute_merge_plan(tokens.reshape(B, S * P, C).float(), r, protect_t)
                merged_attn = make_merged_attention(plan)

        def run(block, x, rope, fn):
            if remat and torch.is_grad_enabled():
                return checkpoint(block, x, rope, fused_ln, fn, use_reentrant=False)
            return block(x, rope, fused_ln, attn_fn=fn)

        outputs: List[torch.Tensor] = []
        for frame_block, global_block in zip(self.frame_blocks, self.global_blocks):
            tokens = run(frame_block, tokens.reshape(B * S, P, C), rope_frame, attn_fn)
            frame_inter = tokens.reshape(B, S, P, C)
            tokens = run(global_block, tokens.reshape(B, S * P, C), rope_global,
                         merged_attn or attn_fn)
            outputs.append(torch.cat([frame_inter, tokens.reshape(B, S, P, C)], dim=-1))
        return outputs, psi
