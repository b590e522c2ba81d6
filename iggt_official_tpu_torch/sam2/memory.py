"""Streaming memory: RoPE attention, memory attention, memory encoder
(counterpart of `iggt_official_tpu/sam2/memory.py`).

- `RoPEAttention` (`sam2/modeling/sam/transformer.py:247-305`) with axial
  rotary tables (`position_encoding.py:179-233`): the first half of the head
  dim's pairs rotate by x, the rest by y over the flattened grid; the tables
  repeat across memory frames (``rope_k_repeat``); the trailing
  ``num_k_exclude_rope`` keys (object pointers) are not rotated; ``key_mask``
  excludes the padding of a fixed-shape memory bank.
- `MemoryAttention(Layer)` (`memory_attention.py:11-163`): pre-norm
  self-attention, cross-attention into the memory, MLP; input position
  scaled by 0.1.
- `MaskDownSampler` / `CXBlock` / `Fuser` / `MemoryEncoder`
  (`memory_encoder.py:11-175`).

These attentions are plain einsum + softmax in the JAX package and stay
plain torch here.  No card path calls this module yet: it is held to the
JAX package on the CPU, and completes the SAM2 checkpoint layout.
Token layout (B, N, C), maps NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.ops.conv import Conv2d
from iggt_official_tpu_torch.sam2.common import LayerNorm2d, PositionEmbeddingSine, gelu


def axial_rope_tables(dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin tables (N, dim // 2) for the flattened (end_y, end_x) grid."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4, dtype=torch.float32, device=device)
                             [: dim // 4] / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    t_x = t % end_x
    t_y = torch.floor(t / end_x)
    ang = torch.cat([torch.outer(t_x, freqs), torch.outer(t_y, freqs)], dim=-1)
    return ang.cos(), ang.sin()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the feature pairs of (..., N, D) by per-position tables (N, D // 2)."""
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    re, im = x2[..., 0], x2[..., 1]
    return torch.stack([re * cos - im * sin, re * sin + im * cos], dim=-1).reshape(x.shape)


class RoPEAttention(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, kv_in_dim: Optional[int] = None,
                 rope_theta: float = 10000.0, rope_k_repeat: bool = False):
        super().__init__()
        self.internal = embedding_dim
        self.num_heads = num_heads
        self.rope_theta = rope_theta
        self.rope_k_repeat = rope_k_repeat
        kv_in = kv_in_dim or embedding_dim
        self.q_proj = nn.Linear(embedding_dim, self.internal)
        self.k_proj = nn.Linear(kv_in, self.internal)
        self.v_proj = nn.Linear(kv_in, self.internal)
        self.out_proj = nn.Linear(self.internal, embedding_dim)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0, key_mask=None):
        hd = self.internal // self.num_heads
        B, Nq = q.shape[:2]
        Nk = k.shape[1]
        qh = self.q_proj(q).reshape(B, Nq, self.num_heads, hd)
        kh = self.k_proj(k).reshape(B, Nk, self.num_heads, hd)
        vh = self.v_proj(v).reshape(B, Nk, self.num_heads, hd)
        side = int(math.sqrt(Nq))
        cos, sin = axial_rope_tables(hd, side, side, self.rope_theta, q.device)
        qh = apply_rotary(qh.transpose(1, 2), cos, sin).transpose(1, 2)
        n_rope = Nk - num_k_exclude_rope
        if n_rope != Nq:
            assert self.rope_k_repeat and n_rope % Nq == 0
            cos_k, sin_k = cos.repeat(n_rope // Nq, 1), sin.repeat(n_rope // Nq, 1)
        else:
            cos_k, sin_k = cos, sin
        k_rope = apply_rotary(kh[:, :n_rope].transpose(1, 2), cos_k, sin_k).transpose(1, 2)
        kh = torch.cat([k_rope, kh[:, n_rope:]], dim=1)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * hd ** -0.5
        if key_mask is not None:
            logits = torch.where(key_mask[:, None, None, :], logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits.float(), -1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, Nq, self.internal)
        return self.out_proj(out)


class MemoryAttentionLayer(nn.Module):
    """`memory_attention.py:11-94` with the Hiera-L flags (no position at the
    self-attention, position on the cross-attention keys)."""

    def __init__(self, d_model: int, dim_feedforward: int, rope_theta: float = 10000.0,
                 kv_in_dim: int = 64):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1, rope_theta=rope_theta)
        self.cross_attn_image = RoPEAttention(d_model, 1, rope_theta=rope_theta,
                                              rope_k_repeat=True, kv_in_dim=kv_in_dim)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, num_k_exclude_rope: int = 0, key_mask=None):
        tgt2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(tgt2, tgt2, tgt2)
        tgt2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(tgt2, memory + pos, memory,
                                          num_k_exclude_rope=num_k_exclude_rope,
                                          key_mask=key_mask)
        tgt2 = self.linear2(torch.relu(self.linear1(self.norm3(tgt))))
        return tgt + tgt2


class MemoryAttention(nn.Module):
    """`memory_attention.py:97-163` (position added at the input, batch first)."""

    def __init__(self, d_model: int, num_layers: int, dim_feedforward: int = 2048,
                 rope_theta: float = 10000.0, kv_in_dim: int = 64):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model, dim_feedforward, rope_theta, kv_in_dim)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model)

    def forward(self, curr, memory, curr_pos=None, memory_pos=None,
                num_obj_ptr_tokens: int = 0, key_mask=None):
        """curr (B, N, C); memory (B, M, kv_in_dim); key_mask (B, M) bool."""
        output = curr if curr_pos is None else curr + 0.1 * curr_pos
        for layer in self.layers:
            output = layer(output, memory, memory_pos, num_k_exclude_rope=num_obj_ptr_tokens,
                           key_mask=key_mask)
        return self.norm(output)


class MaskDownSampler(nn.Module):
    """`memory_encoder.py:11-53`: (conv k3 s2 p1, LayerNorm2d, GELU) x 4, then a
    1x1 conv to embed_dim (``encoder.<3i>``, ``encoder.<3i + 1>``, ``encoder.12``)."""

    def __init__(self, embed_dim: int = 256, kernel_size: int = 3, stride: int = 2,
                 padding: int = 1, total_stride: int = 16):
        super().__init__()
        num_layers = int(math.log2(total_stride) // math.log2(stride))
        layers, chans = [], 1
        for _ in range(num_layers):
            out = chans * stride ** 2
            layers += [Conv2d(chans, out, kernel_size, stride=stride, padding=padding),
                       LayerNorm2d(out), nn.GELU(approximate="tanh")]
            chans = out
        layers.append(Conv2d(chans, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class CXBlock(nn.Module):
    """ConvNeXt block (`memory_encoder.py:57-113`) on NHWC maps."""

    def __init__(self, dim: int, kernel_size: int = 7, padding: int = 3,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y))))
        return x + self.gamma * y


class Fuser(nn.Module):
    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    """`memory_encoder.py:131-175`."""

    def __init__(self, out_dim: int, in_dim: int = 256, num_fuser_layers: int = 2):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(in_dim)
        self.pix_feat_proj = Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, num_fuser_layers)
        self.out_proj = Conv2d(in_dim, out_dim, 1) if out_dim != in_dim else None
        self.position_encoding = PositionEmbeddingSine(out_dim)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False):
        """pix_feat (B, h, w, in_dim); masks (B, 16h, 16w, 1)."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        x = self.fuser(x)
        if self.out_proj is not None:
            x = self.out_proj(x)
        pos = self.position_encoding(x.shape[1], x.shape[2], x.device)
        return {"vision_features": x, "vision_pos_enc": [pos[None].expand(x.shape).to(x.dtype)]}
