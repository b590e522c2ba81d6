"""Joint multi-view PCA colormap of the part features.

Counterpart of `iggt_official_tpu/ops/pca.py` and the demo's
`_normalize_and_pca` (`iggt_official_tpu/app/demo.py:66-71`): flatten all
views, project onto the top-3 principal directions (from the eigenvectors of
the C x C Gram matrix of the centred features, C = 8), then stretch each
channel between its 2% and 98% quantiles.

`eigh` fixes each eigenvector only up to sign, in both packages; a flipped
direction maps a channel x to 1 - x (the 2% and 98% quantiles swap under
negation with linear interpolation), so comparisons are per channel up to
that flip.  `torch.quantile` refuses inputs above 2^24 elements: the (M, 3)
projections fit up to M = 5.59M pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pca_components(flat: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Top-k principal directions (C, k) of (M, C), descending variance.

    The features are centred for the directions (as `torch.pca_lowrank`
    does in the reference) and projected uncentred by the caller."""
    x = flat.to(torch.float32)
    x = x - x.mean(dim=0, keepdim=True)
    _, eigvec = torch.linalg.eigh(x.T @ x)  # ascending
    return eigvec.flip(1)[:, :k]


def apply_pca_colormap(image: torch.Tensor, low_p: float = 0.02,
                       high_p: float = 0.98) -> torch.Tensor:
    """(N, H, W, C) features -> (N, H, W, 3) in [0, 1]."""
    n, h, w, c = image.shape
    flat = image.reshape(-1, c).to(torch.float32)
    colored = flat @ pca_components(flat, 3)  # (M, 3)
    q = torch.tensor([low_p, high_p], dtype=torch.float32, device=flat.device)
    v_low, v_high = torch.quantile(colored, q, dim=0)
    span = v_high - v_low
    normed = torch.where(span > 0, (colored - v_low) / span.clamp_min(1e-12),
                         torch.full_like(colored, 0.5))
    return normed.clamp(0.0, 1.0).reshape(n, h, w, 3)


def normalize_and_pca(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalize the (..., C) features; return them and their PCA colours."""
    feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True).clamp_min(1e-12)
    return feat, apply_pca_colormap(feat)
