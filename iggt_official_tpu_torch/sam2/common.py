"""Shared SAM2 primitives (counterpart of `iggt_official_tpu/sam2/common.py`).

- `window_partition` / `window_unpartition` (`sam2/modeling/backbones/utils.py`),
  on channels-last (B, H, W, C) maps, zero-padding to whole windows.
- `MLP` (`sam2_utils.py:105-129`): ``layers.<i>`` Linear layers.
- `LayerNorm2d` (`sam2_utils.py:134-146`): a LayerNorm over the channel
  (last) axis of NHWC maps, two-pass variance, eps 1e-6.
- `PositionEmbeddingSine` (`position_encoding.py:10-140`): the normalized
  sine grid embedding, and the point / box encodings.
- `gelu`: flax's default GELU, the tanh approximation, which the JAX
  package uses wherever SAM2 applies a GELU.

Activations keep the JAX package's NHWC layout; parameters keep the
reference checkpoint's names and layouts.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nw, ws, ws, C), zero-padding H and W to multiples of ws."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // ws) * (Wp // ws))
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W]


class MLP(nn.Module):
    """``num_layers`` Linear layers with ``activation`` between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 activation=F.relu, sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation = activation
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class LayerNorm2d(nn.Module):
    """Channel LayerNorm on NHWC maps: (x - mu) / sqrt(var + eps) * weight + bias,
    var the mean of (x - mu)^2, in fp32."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(-1, keepdim=True)
        s = ((xf - u) ** 2).mean(-1, keepdim=True)
        out = (xf - u) * torch.rsqrt(s + self.eps)
        return (out * self.weight + self.bias).to(x.dtype)


class PositionEmbeddingSine:
    """Sine position embedding (no parameters).

    ``pe(h, w, device)`` is the (h, w, 2 * num_pos_feats) grid embedding
    (y features then x features); `encode_points` / `encode_boxes` embed
    normalized coordinates."""

    def __init__(self, num_pos_feats: int, temperature: int = 10000, normalize: bool = True,
                 scale: Optional[float] = None):
        assert num_pos_feats % 2 == 0
        self.num_pos_feats = num_pos_feats // 2
        self.temperature = temperature
        self.normalize = normalize
        self.scale = 2 * math.pi if scale is None else scale

    def _dim_t(self, device) -> torch.Tensor:
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=device)
        return self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                    / self.num_pos_feats)

    @staticmethod
    def _interleave(p: torch.Tensor) -> torch.Tensor:
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).flatten(-2)

    def __call__(self, h: int, w: int, device=None) -> torch.Tensor:
        y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
        x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
        if self.normalize:
            eps = 1e-6
            y = y / (y[-1:, :] + eps) * self.scale
            x = x / (x[:, -1:] + eps) * self.scale
        dim_t = self._dim_t(device)
        return torch.cat([self._interleave(y[..., None] / dim_t),
                          self._interleave(x[..., None] / dim_t)], dim=-1)

    def _encode_xy(self, x: torch.Tensor, y: torch.Tensor):
        dim_t = self._dim_t(x.device)
        return (self._interleave((x * self.scale)[..., None] / dim_t),
                self._interleave((y * self.scale)[..., None] / dim_t))

    def encode_boxes(self, x, y, w, h) -> torch.Tensor:
        pos_x, pos_y = self._encode_xy(x, y)
        return torch.cat([pos_y, pos_x, h[..., None], w[..., None]], -1)

    def encode_points(self, x, y, labels) -> torch.Tensor:
        pos_x, pos_y = self._encode_xy(x, y)
        return torch.cat([pos_y, pos_x, labels[..., None]], -1)
