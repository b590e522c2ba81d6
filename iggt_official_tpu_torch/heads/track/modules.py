"""The tracker's transformer blocks.

Counterpart of `iggt_official_tpu/heads/track/modules.py`, with the
reference's quirks:

- `AttnBlock` / `CrossAttnBlock` rebind x to its pre-norm before the
  residual, so the residual stream carries the normalized activations;
- `TorchMHA` keeps `nn.MultiheadAttention`'s parameter layout (one packed
  ``in_proj_weight`` / ``in_proj_bias``, then ``out_proj``) for the
  checkpoint.  Its attention (8 heads of 48) is `sdpa_plain`, as the JAX
  package's is `sdpa_xla`: no Pallas kernel there, and 48 is not a head dim of
  the flash kernel.

Everything computes in fp32; LayerNorms use eps 1e-5 and the fast variance
(flax's default, which the JAX package keeps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm, Linear, Mlp, sdpa_plain


class TorchMHA(nn.Module):
    """`nn.MultiheadAttention` (batch_first, no dropout) as the JAX package
    computes it."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        E, nh = self.embed_dim, self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        B, Nq, _ = q.shape
        qh = F.linear(q, w[:E], b[:E]).reshape(B, Nq, nh, E // nh)
        kh = F.linear(k, w[E:2 * E], b[E:2 * E]).reshape(B, -1, nh, E // nh)
        vh = F.linear(v, w[2 * E:], b[2 * E:]).reshape(B, -1, nh, E // nh)
        return self.out_proj(sdpa_plain(qh, kh, vh).reshape(B, Nq, E))


class AttnBlock(nn.Module):
    """Self-attention block, residual from the normalized input."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(hidden_size)
        self.attn = TorchMHA(hidden_size, num_heads)
        self.norm2 = LayerNorm(hidden_size)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        x = x + self.attn(x, x, x)
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    """Cross-attention block, residual from the normalized input."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(hidden_size)
        self.norm_context = LayerNorm(hidden_size)
        self.cross_attn = TorchMHA(hidden_size, num_heads)
        self.norm2 = LayerNorm(hidden_size)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        context = self.norm_context(context)
        x = x + self.cross_attn(x, context, context)
        return x + self.mlp(self.norm2(x))


class EfficientUpdateFormer(nn.Module):
    """Time attention over each track's frames, alternating with space
    attention through 64 virtual tracks (virtual <- points, virtual self,
    points <- virtual)."""

    def __init__(self, space_depth: int = 6, time_depth: int = 6, input_dim: int = 388,
                 hidden_size: int = 384, num_heads: int = 8, output_dim: int = 130,
                 mlp_ratio: float = 4.0, add_space_attn: bool = True,
                 num_virtual_tracks: int = 64):
        super().__init__()
        self.hidden_size = hidden_size
        self.add_space_attn = add_space_attn
        self.num_virtual_tracks = num_virtual_tracks
        self.input_norm = LayerNorm(input_dim)
        self.input_transform = Linear(input_dim, hidden_size)
        self.time_blocks = nn.ModuleList(
            AttnBlock(hidden_size, num_heads, mlp_ratio) for _ in range(time_depth))
        if add_space_attn:
            # (sic) the reference's parameter name
            self.virual_tracks = nn.Parameter(torch.zeros(1, num_virtual_tracks, 1,
                                                          hidden_size))
            self.space_virtual_blocks = nn.ModuleList(
                AttnBlock(hidden_size, num_heads, mlp_ratio) for _ in range(space_depth))
            self.space_point2virtual_blocks = nn.ModuleList(
                CrossAttnBlock(hidden_size, num_heads, mlp_ratio) for _ in range(space_depth))
            self.space_virtual2point_blocks = nn.ModuleList(
                CrossAttnBlock(hidden_size, num_heads, mlp_ratio) for _ in range(space_depth))
        self.output_norm = LayerNorm(hidden_size)
        self.flow_head = Linear(hidden_size, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, T, input_dim) -> (B, N, T, output_dim)."""
        B, _, T, _ = x.shape
        D, nv = self.hidden_size, self.num_virtual_tracks
        tokens = self.input_transform(self.input_norm(x))
        init_tokens = tokens
        if self.add_space_attn:
            tokens = torch.cat([tokens, self.virual_tracks.expand(B, nv, T, D)], dim=1)
        N = tokens.shape[1]
        depth = len(self.time_blocks)
        every = depth // len(self.space_virtual_blocks) if self.add_space_attn else 0
        j = 0
        for i, time_block in enumerate(self.time_blocks):
            tokens = time_block(tokens.reshape(B * N, T, D)).reshape(B, N, T, D)
            if self.add_space_attn and i % every == 0:
                st = tokens.transpose(1, 2).reshape(B * T, N, D)
                pts, virt = st[:, :N - nv], st[:, N - nv:]
                virt = self.space_virtual2point_blocks[j](virt, pts)
                virt = self.space_virtual_blocks[j](virt)
                pts = self.space_point2virtual_blocks[j](pts, virt)
                tokens = torch.cat([pts, virt], dim=1).reshape(B, T, N, D).transpose(1, 2)
                j += 1
        if self.add_space_attn:
            tokens = tokens[:, :N - nv]
        return self.flow_head(self.output_norm(tokens + init_tokens))
