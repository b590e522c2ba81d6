"""Batched 2D connected components (counterpart of
`iggt_official_tpu/ops/connected_components.py`).

8-connectivity components of a boolean mask, as the reference's CUDA kernel
(`sam2/csrc/connected_components.cu`) defines them: each pixel of a
component gets the component's label, its smallest linear pixel index + 1
(background 0), and the component's area (background 0).

`connected_components` is the JAX package's XLA algorithm in torch ops,
which run on the tensor's device: labels start as each pixel's linear
index; every sweep takes the 3x3 neighbourhood minimum (a max-pool of the
negated labels) and jumps twice through the label graph (labels[p] <-
labels[labels[p]]), until nothing changes, which takes O(log diameter)
sweeps; areas come from one scatter-add over the labels.  The JAX package
runs it as XLA code, not as a Pallas kernel, so plain torch is its port.
`connected_components_host` takes numpy masks through the port's C++
union-find (`native/postproc.cpp`, `ccl2d`), with the same labels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_INF = torch.iinfo(torch.int32).max


def _min_pool_8(labels: torch.Tensor) -> torch.Tensor:
    """3x3 minimum over the 8-neighbourhood and the pixel itself, INF outside.
    Labels are int32 < 2^31, exact in float64."""
    neg = -labels.to(torch.float64)[:, None]
    pooled = F.max_pool2d(F.pad(neg, (1, 1, 1, 1), value=-float(_INF)), 3, stride=1)
    return (-pooled[:, 0]).to(torch.int32)


@torch.no_grad()
def connected_components(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (B, H, W) bool -> (labels (B, H, W) int32, areas (B, H, W) int32)."""
    B, H, W = mask.shape
    n = H * W
    idx = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(1, H, W)
    inf = torch.full((), _INF, dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, idx.expand(B, H, W), inf)

    def jump(flat):
        nxt = torch.gather(flat, 1, flat.clamp(0, n - 1).long())
        return torch.where(flat == _INF, flat, nxt)

    while True:
        prop = torch.where(mask, _min_pool_8(labels), inf)
        new = jump(jump(prop.reshape(B, n))).reshape(B, H, W)
        if torch.equal(new, labels):
            break
        labels = new
    flat = labels.reshape(B, n)
    bg = flat == _INF
    safe = torch.where(bg, torch.zeros_like(flat), flat).long()
    counts = torch.zeros((B, n), dtype=torch.int32, device=mask.device)
    counts.scatter_add_(1, safe, (~bg).to(torch.int32))
    areas = torch.where(bg, torch.zeros_like(flat), torch.gather(counts, 1, safe))
    out = torch.where(bg, torch.zeros_like(flat), flat + 1)
    return out.reshape(B, H, W), areas.reshape(B, H, W)


def fill_small_components(scores: torch.Tensor, select: torch.Tensor, max_area: float,
                          value: float) -> torch.Tensor:
    """``scores`` (B, H, W) with every pixel of a component of ``select``
    (B, H, W bool) whose area is <= max_area set to ``value``."""
    labels, areas = connected_components(select)
    return torch.where((labels > 0) & (areas <= max_area),
                       torch.full_like(scores, value), scores)


def fill_holes_in_mask_scores(mask: torch.Tensor, max_area: int) -> torch.Tensor:
    """Background (<= 0) components of area <= max_area set to 0.1
    (`sam2/utils/misc.py:306-333`)."""
    assert max_area > 0
    m = mask.reshape((-1,) + mask.shape[-2:])
    return fill_small_components(m, m <= 0, max_area, 0.1).reshape(mask.shape)


def remove_small_sparks(mask: torch.Tensor, max_area: int) -> torch.Tensor:
    """Foreground (> 0) components of area <= max_area set to -0.1
    (`sam2/utils/transforms.py:74-97`)."""
    assert max_area > 0
    m = mask.reshape((-1,) + mask.shape[-2:])
    return fill_small_components(m, m > 0, max_area, -0.1).reshape(mask.shape)


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) masks -> (..., 4) int32 boxes (x0, y0, x1, y1) (`sam2/utils/misc.py:60-95`);
    an empty mask gives (W, H, -1, -1)."""
    *lead, H, W = masks.shape
    m = masks.reshape(-1, H, W).bool()
    xs = torch.arange(W, dtype=torch.int32, device=m.device)[None, None, :].expand(m.shape)
    ys = torch.arange(H, dtype=torch.int32, device=m.device)[None, :, None].expand(m.shape)

    def reduce(grid, fill, fn):
        return fn(torch.where(m, grid, torch.full_like(grid, fill)).flatten(1), dim=1).values

    box = torch.stack([reduce(xs, W, torch.min), reduce(ys, H, torch.min),
                       reduce(xs, -1, torch.max), reduce(ys, -1, torch.max)], dim=-1)
    return box.reshape(tuple(lead) + (4,))


def connected_components_host(mask) -> Tuple[np.ndarray, np.ndarray]:
    """Batched CCL of numpy masks (B, H, W) through the native library's
    union-find: (labels int32, areas int32), the labels of `connected_components`."""
    from iggt_official_tpu_torch import native

    return native.connected_components(np.asarray(mask).astype(bool))
