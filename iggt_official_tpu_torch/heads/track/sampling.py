"""Bilinear point sampling and the tracker's positional embeddings.

Counterpart of `iggt_official_tpu/heads/track/sampling.py`, channels-last:

- `bilinear_sample_nhwc`: align_corners sampling at pixel coordinates
  (x in [0, W - 1], y in [0, H - 1]) with "border" (clamped corners) or
  "zeros" (corners outside the map read 0) padding, the four corners
  gathered and weighted in the JAX package's order, so both packages compute
  the same sums;
- `get_2d_embedding`: interleaved sin / cos of x, then of y;
- `get_2d_sincos_pos_embed`: a (1, H, W, D) grid embedding, the first D/2
  channels encoding x, the rest y, each as [sin(D/4) ++ cos(D/4)].
"""

from __future__ import annotations

from typing import Tuple

import torch


def bilinear_sample_nhwc(fmap: torch.Tensor, coords: torch.Tensor,
                         padding_mode: str = "border") -> torch.Tensor:
    """Sample (B, H, W, C) at pixel coords (B, ..., 2) [x, y] -> (B, ..., C)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    B, H, W, C = fmap.shape
    lead = coords.shape[1:-1]
    xy = coords.reshape(B, -1, 2).float()
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = fmap.reshape(B, H * W, C)

    def gather(yi, xi):
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        vals = flat.gather(1, (yc * W + xc)[..., None].expand(-1, -1, C))
        if padding_mode == "zeros":
            inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
            vals = vals * inside[..., None].to(vals.dtype)
        return vals

    out = (gather(y0, x0) * (1 - wy) * (1 - wx)
           + gather(y0, x0 + 1) * (1 - wy) * wx
           + gather(y0 + 1, x0) * wy * (1 - wx)
           + gather(y0 + 1, x0 + 1) * wy * wx)
    return out.reshape(B, *lead, C)


def get_2d_embedding(xy: torch.Tensor, C: int) -> torch.Tensor:
    """(B, N, 2) -> (B, N, 2C): per coordinate C channels sin, cos, sin, cos, ..."""
    x = xy[..., 0:1].float()
    y = xy[..., 1:2].float()
    div = torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C)

    def interleave(t):
        return torch.stack([torch.sin(t * div), torch.cos(t * div)], -1).flatten(-2)

    return torch.cat([interleave(x), interleave(y)], dim=-1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_hw: Tuple[int, int],
                            device=None) -> torch.Tensor:
    """(1, H, W, embed_dim) fp32 grid embedding."""
    H, W = grid_hw
    gx = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    gy = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)

    def embed_1d(pos, dim):
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
        out = pos.reshape(-1)[:, None] * (1.0 / 10000 ** omega)[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    emb = torch.cat([embed_1d(gx, embed_dim // 2), embed_1d(gy, embed_dim // 2)], dim=1)
    return emb.reshape(1, H, W, embed_dim)
