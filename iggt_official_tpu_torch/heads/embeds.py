"""UV grids and sincos positional embeddings for the dense heads.

Counterpart of `iggt_official_tpu/heads/embeds.py` (fp32 throughout).
"""

from __future__ import annotations

from typing import Optional

import torch


def make_sincos_pos_embed(embed_dim: int, pos: torch.Tensor,
                          omega_0: float = 100.0) -> torch.Tensor:
    """1-D sincos embedding: (M,) positions -> (M, embed_dim)."""
    if embed_dim % 2:
        raise ValueError("embed_dim must be even")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / omega_0 ** (omega / (embed_dim / 2.0))
    out = torch.einsum("m,d->md", pos.reshape(-1).float(), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def position_grid_to_embed(pos_grid: torch.Tensor, embed_dim: int,
                           omega_0: float = 100.0) -> torch.Tensor:
    """(H, W, 2) uv grid -> (H, W, embed_dim): channel 0 (u) fills the first
    half of the embedding, channel 1 (v) the second."""
    H, W, _ = pos_grid.shape
    flat = pos_grid.reshape(-1, 2)
    emb_x = make_sincos_pos_embed(embed_dim // 2, flat[:, 0], omega_0)
    emb_y = make_sincos_pos_embed(embed_dim // 2, flat[:, 1], omega_0)
    return torch.cat([emb_x, emb_y], dim=-1).reshape(H, W, embed_dim)


def create_uv_grid(width: int, height: int, aspect_ratio: Optional[float] = None,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Normalized (height, width, 2) UV grid spanning +-aspect/diag horizontally
    and +-1/diag vertically, with half-pixel insets."""
    if aspect_ratio is None:
        aspect_ratio = float(width) / float(height)
    diag = (aspect_ratio ** 2 + 1.0) ** 0.5
    span_x = aspect_ratio / diag
    span_y = 1.0 / diag
    x = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width,
                       width, dtype=dtype, device=device)
    y = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height,
                       height, dtype=dtype, device=device)
    uu = x[None, :].expand(height, width)
    vv = y[:, None].expand(height, width)
    return torch.stack([uu, vv], dim=-1)
