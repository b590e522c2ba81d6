"""Image resizing ops on channels-last (..., H, W, C) tensors.

Counterpart of `iggt_official_tpu/ops/interpolate.py`; both resizes are
separable contractions with dense 1-D weight matrices, computed the way the
JAX package computes them:

- `bilinear_resize_align_corners`: each output row of the matrix carries the
  two weights (1 - frac, frac) of align_corners=True bilinear sampling.
- `resize_antialias_bicubic`: the scale-and-translate weights of
  `jax.image.resize(method="cubic")` (Keys a = -0.5, kernel widened by the
  downscale factor, columns normalized), which is what the JAX DINOv2
  pos-embed interpolation uses; `F.interpolate(antialias=True)` differs from
  it by ~1e-3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _interp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(out_size, in_size) align_corners bilinear weights."""
    scale = 0.0 if out_size == 1 else (in_size - 1) / (out_size - 1)
    coords = torch.arange(out_size, dtype=dtype, device=device) * scale
    idx0 = torch.clamp(torch.floor(coords), 0, in_size - 1).long()
    idx1 = torch.clamp(idx0 + 1, 0, in_size - 1)
    frac = coords - idx0.to(dtype)
    rows = torch.arange(out_size, device=device)
    m = torch.zeros((out_size, in_size), dtype=dtype, device=device)
    m.index_put_((rows, idx0), 1 - frac, accumulate=True)
    m.index_put_((rows, idx1), frac, accumulate=True)
    return m


def bilinear_resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (..., H, W, C) tensors."""
    H_out, W_out = out_hw
    H, W = x.shape[-3], x.shape[-2]
    if (H, W) == (H_out, W_out):
        return x
    dtype = x.dtype if x.is_floating_point() else torch.float32
    xf = x.to(dtype)
    A = _interp_matrix(H, H_out, dtype, x.device)
    B = _interp_matrix(W, W_out, dtype, x.device)
    xf = torch.einsum("hH,...Hwc->...hwc", A, xf)
    out = torch.einsum("wW,...hWc->...hwc", B, xf)
    return out.to(x.dtype)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _cubic_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) antialiased Keys-cubic weights, fp32, as
    `jax.image.resize` builds them (scale = out / in, no translation)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_antialias_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bicubic resize of (..., H, W, C) in fp32, returned in x's dtype."""
    H, W = x.shape[-3], x.shape[-2]
    out = x.float()
    if H != out_hw[0]:
        wh = torch.from_numpy(_cubic_weight_matrix(H, out_hw[0])).to(x.device)
        out = torch.einsum("Hh,...Hwc->...hwc", wh, out)
    if W != out_hw[1]:
        ww = torch.from_numpy(_cubic_weight_matrix(W, out_hw[1])).to(x.device)
        out = torch.einsum("Ww,...hWc->...hwc", ww, out)
    return out.to(x.dtype)
