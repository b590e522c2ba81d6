"""SAM2 model factories (counterpart of `iggt_official_tpu/sam2/build.py`).

`build_sam2(cfg, checkpoint, device, seed)` builds `SAM2Base` on ``device``
(the card unless the caller asks for another), randomly initialized from
``seed`` the way the JAX package's flax initializers do (no init on the
"meta" device), and merges a released SAM2 checkpoint into it when one is
named (`utils/checkpoint.py::load_reference_state`):

- Linear / Conv2d / ConvTranspose2d weights lecun normal (fan in =
  in_features, or in_channels / groups * kh * kw), biases 0;
- LayerNorm / LayerNorm2d weight 1, bias 0;
- the embedding tables (point, not-a-point, no-mask, IoU, mask and
  object-score tokens) and the random-Fourier matrix normal(1);
- the memory embeddings (``maskmem_tpos_enc``, ``no_mem_*``,
  ``no_obj_ptr``, ``no_obj_embed_spatial``) 0.02 times a unit normal
  truncated to [-2, 2];
- the Hiera position embeddings 0, the ConvNeXt layer scale 1e-6.

Random numbers come from one `torch.Generator` on the parameters' device,
in module order; they are not the JAX package's numbers (tests carry
weights across with `utils/convert.py::jax_sam2_params_to_torch_state_dict`).
"""

from __future__ import annotations

import logging
from typing import Optional, Union

import torch
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.sam2.base import SAM2Base
from iggt_official_tpu_torch.sam2.common import LayerNorm2d
from iggt_official_tpu_torch.sam2.config import SAM2Config
from iggt_official_tpu_torch.sam2.image_predictor import SAM2ImagePredictor
from iggt_official_tpu_torch.sam2.video_predictor import SAM2VideoPredictor
from iggt_official_tpu_torch.utils.device import resolve_device
from iggt_official_tpu_torch.utils.init import _lecun_normal_

logger = logging.getLogger(__name__)

_MEMORY_EMBEDS = {"maskmem_tpos_enc", "no_mem_embed", "no_mem_pos_enc", "no_obj_ptr",
                  "no_obj_embed_spatial"}


@torch.no_grad()
def init_sam2_params(model: nn.Module, gen: torch.Generator) -> None:
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            if isinstance(module, nn.Linear):
                fan_in = module.in_features
            else:   # (out, in / groups, kh, kw); transposed: (in, out, kh, kw)
                fan_in = w.shape[int(isinstance(module, nn.Conv2d))] * w.shape[2] * w.shape[3]
            _lecun_normal_(w, fan_in, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, LayerNorm2d)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=gen)
        else:
            for name, p in module.named_parameters(recurse=False):
                if name == "positional_encoding_gaussian_matrix":
                    p.normal_(0.0, 1.0, generator=gen)
                elif name in _MEMORY_EMBEDS:
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=gen)
                elif name in ("pos_embed", "pos_embed_window"):
                    p.zero_()
                elif name == "gamma":
                    p.fill_(1e-6)
                else:
                    raise ValueError(f"no init rule for parameter {name} of "
                                     f"{type(module).__name__}")


def build_sam2(cfg: Optional[SAM2Config] = None, checkpoint: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None, seed: int = 0) -> SAM2Base:
    """SAM2Base in eval mode with gradients off; with ``checkpoint``, a released
    SAM2 checkpoint merged by name (the report on the model's ``load_report``)."""
    cfg = cfg or SAM2Config()
    dev = resolve_device(device)
    with torch.device(dev):
        model = SAM2Base(cfg)
    if dev.type != "meta":
        init_sam2_params(model, torch.Generator(device=dev).manual_seed(seed))
    model.load_report = None
    if checkpoint is not None:
        from iggt_official_tpu_torch.utils.checkpoint import (load_reference_state,
                                                              read_checkpoint)

        model.load_report = load_reference_state(model, read_checkpoint(checkpoint),
                                                 log=logger.info)
    return model.eval().requires_grad_(False)


def build_sam2_image_predictor(cfg: Optional[SAM2Config] = None,
                               checkpoint: Optional[str] = None,
                               device: Optional[Union[str, torch.device]] = None,
                               seed: int = 0, **kw) -> SAM2ImagePredictor:
    return SAM2ImagePredictor(build_sam2(cfg, checkpoint, device, seed), **kw)


def build_sam2_video_predictor(cfg: Optional[SAM2Config] = None,
                               checkpoint: Optional[str] = None,
                               device: Optional[Union[str, torch.device]] = None,
                               seed: int = 0, **kw) -> SAM2VideoPredictor:
    return SAM2VideoPredictor(build_sam2(cfg, checkpoint, device, seed), **kw)
