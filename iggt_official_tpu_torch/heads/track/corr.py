"""Correlation pyramid lookup for the tracker.

Counterpart of `iggt_official_tpu/heads/track/corr.py`: a 2x2 average-pooled
feature pyramid; at each level the track features correlate with the whole
map (one matmul), and the (2r+1)^2 window around each track's coordinate
(scaled to the level) is bilinearly sampled from the correlation map with
zero padding.  Each level's correlation (B * S * N, h, w) fp32 is freed once
it is sampled, so at most one level's map is held at a time.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from iggt_official_tpu_torch.heads.track.sampling import bilinear_sample_nhwc


def build_pyramid(fmaps: torch.Tensor, num_levels: int
                  ) -> Tuple[List[torch.Tensor], List[float]]:
    """(B, S, H, W, C) -> (levels, scales), each level 2x2 average-pooled
    (odd rows / columns dropped).  Once a dimension is below 2 the coarsest
    level repeats, with its real cumulative scale, so the concatenated
    correlation width stays num_levels * (2r+1)^2."""
    B, S, H, W, C = fmaps.shape
    levels, scales = [fmaps], [1.0]
    cur = fmaps.reshape(B * S, H, W, C)
    scale = 1.0
    for _ in range(num_levels - 1):
        h, w = cur.shape[1], cur.shape[2]
        if h >= 2 and w >= 2:
            h, w = h // 2, w // 2
            c = cur[:, :2 * h, :2 * w].reshape(B * S, h, 2, w, 2, C)
            cur = (((c[:, :, 0, :, 0] + c[:, :, 0, :, 1]) + c[:, :, 1, :, 0])
                   + c[:, :, 1, :, 1]) / 4.0
            scale *= 2.0
        levels.append(cur.reshape(B, S, h, w, C))
        scales.append(scale)
    return levels, scales


def window_offsets(radius: int, device=None) -> torch.Tensor:
    """(1, (2r+1)^2, 2) [x, y] offsets, the x offset on the outer axis (the
    reference adds meshgrid(dy, dx, 'ij') to (x, y) coordinates)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    n = 2 * radius + 1
    return torch.stack([d[:, None].expand(n, n), d[None, :].expand(n, n)],
                       dim=-1).reshape(1, n * n, 2)


def corr_sample(pyramid: List[torch.Tensor], scales: List[float], targets: torch.Tensor,
                coords: torch.Tensor, radius: int) -> torch.Tensor:
    """targets (B, S, N, C), coords (B, S, N, 2) full-resolution pixel
    coordinates -> (B, S, N, levels * (2r+1)^2)."""
    B, S, N, C = targets.shape
    K = (2 * radius + 1) ** 2
    dgrid = window_offsets(radius, targets.device)
    out = []
    for fm, scale in zip(pyramid, scales):
        h, w = fm.shape[2], fm.shape[3]
        corr = torch.einsum("bsnc,bskc->bsnk", targets, fm.reshape(B, S, h * w, C))
        corr = (corr / math.sqrt(C)).reshape(B * S * N, h, w, 1)
        pts = coords.reshape(B * S * N, 1, 2) / scale + dgrid
        out.append(bilinear_sample_nhwc(corr, pts, padding_mode="zeros").reshape(B, S, N, K))
        del corr
    return torch.cat(out, dim=-1)
