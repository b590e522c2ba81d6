"""Deterministic random init mirroring the JAX package's flax initializers.

- Linear / Conv2d / ConvTranspose2d weights: lecun normal (truncated normal
  on [-2, 2] std, std = sqrt(1 / fan_in) / .87962566103423978), biases 0.
  fan_in is in_features, or in_channels * kh * kw for both conv kinds (the
  JAX ConvTranspose2d kernel is (kh, kw, in, out)).
- LayerNorm / HeadLayerNorm / BatchNorm: weight 1, bias 0, running stats 0 / 1.
- LayerScale: its constant.
- camera / register tokens normal(1e-6); DINOv2 pos_embed normal(0.02), its
  cls and register tokens 0; relative-position bias tables truncated
  normal(0.02) on [-2, 2]; empty pose tokens 0.

Random numbers come from an explicit `torch.Generator` on the parameters'
device, in module order, so a seed fixes the weights.  They are not the JAX
package's numbers: tests carry weights across with `utils/convert.py`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from iggt_official_tpu_torch.layers.blocks import HeadLayerNorm, LayerNorm, LayerScale
from iggt_official_tpu_torch.ops.conv import FrozenBatchNorm

_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]

_NORMAL_STD = {"camera_token": 1e-6, "register_token": 1e-6, "pos_embed": 0.02}
_ZERO = {"cls_token", "register_tokens", "empty_pose_tokens"}


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    for module in model.modules():
        if isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, gen)
        elif isinstance(module, nn.Conv2d):
            kh, kw = module.kernel_size
            _lecun_normal_(module.weight, module.in_channels * kh * kw, gen)
        elif isinstance(module, nn.ConvTranspose2d):
            kh, kw = module.kernel_size
            _lecun_normal_(module.weight, module.in_channels * kh * kw, gen)
        elif isinstance(module, (LayerNorm, HeadLayerNorm, FrozenBatchNorm)):
            if module.weight is not None:
                module.weight.fill_(1.0)
                module.bias.zero_()
            if isinstance(module, FrozenBatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            continue
        elif isinstance(module, LayerScale):
            module.gamma.fill_(module.init_values)
            continue
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            if module.bias is not None:
                module.bias.zero_()
            continue
        for name, param in module.named_parameters(recurse=False):
            if name in _NORMAL_STD:
                param.normal_(0.0, _NORMAL_STD[name], generator=gen)
            elif name in _ZERO:
                param.zero_()
            elif name == "relative_position_bias_table":
                nn.init.trunc_normal_(param, std=0.02, a=-0.04, b=0.04, generator=gen)
            else:
                raise ValueError(f"no init rule for parameter {name} of "
                                 f"{type(module).__name__}")
