"""2D rotary position embeddings (counterpart of `iggt_official_tpu/layers/rope.py`).

Patch positions are 1-based (y, x) grid coordinates; the special tokens sit
at (0, 0).  Each spatial direction rotates half the head dim with D/4
frequencies duplicated over the two rotation lanes.  The per-token cos/sin
tables are computed once per forward in fp32 and shared by every block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Rope2DTables(NamedTuple):
    """Per-token rotation tables, each of shape (..., N, head_dim // 2)."""

    cos_y: torch.Tensor
    sin_y: torch.Tensor
    cos_x: torch.Tensor
    sin_x: torch.Tensor

    def map(self, fn) -> "Rope2DTables":
        return Rope2DTables(*(fn(t) for t in self))


def make_patch_positions(
    height: int, width: int, batch: int, patch_start_idx: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Integer (y, x) positions for [special tokens + patch grid], 1-based.

    Returns (batch, patch_start_idx + height * width, 2) int32."""
    y = torch.arange(height, dtype=torch.int32, device=device)[:, None] + 1
    x = torch.arange(width, dtype=torch.int32, device=device)[None, :] + 1
    grid = torch.stack(torch.broadcast_tensors(y, x), dim=-1).reshape(height * width, 2)
    special = torch.zeros((patch_start_idx, 2), dtype=torch.int32, device=device)
    pos = torch.cat([special, grid], dim=0)
    return pos[None].expand(batch, -1, -1)


def compute_rope_2d(
    positions: torch.Tensor, head_dim: int, base_frequency: float = 100.0
) -> Rope2DTables:
    """cos/sin tables from integer positions (..., N, 2), fp32."""
    if head_dim % 4:
        raise ValueError("head_dim must be divisible by 4 for 2D RoPE")
    dim = head_dim // 2
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=positions.device) / dim
    inv_freq = 1.0 / (base_frequency ** exponents)
    pos = positions.float()
    ang_y = pos[..., 0:1] * inv_freq
    ang_x = pos[..., 1:2] * inv_freq
    return Rope2DTables(torch.cos(ang_y), torch.sin(ang_y),
                        torch.cos(ang_x), torch.sin(ang_x))


def pack_rope_tables(tables: Rope2DTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 4 per-direction tables as full-head-dim (..., N, D) cos / sin:
    features [0, D/2) rotate by y with [cos_y, cos_y], [D/2, D) by x."""
    cos = torch.cat([tables.cos_y, tables.cos_y, tables.cos_x, tables.cos_x], dim=-1)
    sin = torch.cat([tables.sin_y, tables.sin_y, tables.sin_x, tables.sin_x], dim=-1)
    return cos, sin


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_1d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    cs = torch.cat([cos, cos], dim=-1)[..., None, :]
    sn = torch.cat([sin, sin], dim=-1)[..., None, :]
    return x * cs + _rotate_half(x) * sn


def apply_rope_2d(x: torch.Tensor, tables: Rope2DTables) -> torch.Tensor:
    """2D RoPE on (..., N, num_heads, head_dim) tokens, in fp32; returns x's dtype."""
    in_dtype = x.dtype
    x = x.float()
    vert, horz = x.chunk(2, dim=-1)
    vert = _apply_1d(vert, tables.cos_y, tables.sin_y)
    horz = _apply_1d(horz, tables.cos_x, tables.sin_x)
    return torch.cat([vert, horz], dim=-1).to(in_dtype)
