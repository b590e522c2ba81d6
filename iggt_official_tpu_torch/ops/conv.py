"""Convolutions on channels-last (N, H, W, C) tensors, torch parameter layout.

Counterpart of `iggt_official_tpu/ops/conv.py`.  The modules keep torch's
own parameters (Conv2d weight (out, in, kh, kw); ConvTranspose2d weight
(in, out, kh, kw); BatchNorm weight / bias / running stats), so the model's
`state_dict()` is the reference checkpoint layout, while the heads keep the
JAX package's NHWC activations.  NHWC -> NCHW is a permuted view (a
channels-last NCHW tensor), so no copy is made around the convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """torch Conv2d applied to NHWC input, computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d applied to NHWC input, computing in ``dtype``;
    output size (i - 1) * s + k - 2p, as in torch.

    cuDNN runs a transposed convolution as a convolution's data gradient, and
    where the kernel overlaps itself (k > s, the SamProjector's k 4, s 2) its
    default algorithms sum with atomics, so the same input gave other bytes
    from run to run on the card.  The call picks a deterministic algorithm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), bias,
                                   self.stride, self.padding)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Inference-form BatchNorm2d over the channel (last) axis.

    y = (x - running_mean) * rsqrt(running_var + eps) * weight + bias, in fp32,
    returned in x's dtype.  Keeps BatchNorm2d's state-dict entries.  The
    running statistics are parameters, as in the JAX package (its ``mean`` /
    ``var`` params), so the training step gives them gradients and updates
    them with the optimizer as it does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv + self.bias).to(x.dtype)
