"""IGGT model assembly.

Counterpart of `iggt_official_tpu/models/vggt.py` (`IGGT`, `build_model`):
aggregator -> camera head, depth head, point head (which also emits its
fusion pyramid), SamProjector + PartHead.  The trunk runs in
``cfg.trunk_dtype`` (bf16); the depth, point and part decode paths compute in
``cfg.head_dtype`` (fp32 by default, bf16 as the fast mode), the camera head
in fp32.  ``forward(images, fused_ln=True)`` runs the trunk's pre-norms
through the fused LayerNorm kernel, as the JAX package takes the flag at
apply time.
Outputs are channels-last: depth (B,S,H,W,1), world_points (B,S,H,W,3),
part_feat (B,S,H,W,8), pose_enc (B,S,9).

The dense heads decode views in chunks of at most ``frames_chunk_size``
(the largest divisor of S within the bound), a Python loop here, so their
full-resolution fp32 activations are bounded by the chunk, not by S.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.heads.adaptor import SamProjector
from iggt_official_tpu_torch.heads.camera_head import CameraHead
from iggt_official_tpu_torch.heads.dpt_head import DPTHead
from iggt_official_tpu_torch.heads.part_head import PartHead
from iggt_official_tpu_torch.models.aggregator import Aggregator
from iggt_official_tpu_torch.utils.device import resolve_device, torch_dtype
from iggt_official_tpu_torch.utils.init import init_params


def _view_chunks(S: int, chunk_size: int) -> List[slice]:
    """View slices of the largest chunk that divides S within ``chunk_size``
    (all S views at once when S fits or the bound is 0)."""
    if not chunk_size or S <= chunk_size:
        return [slice(0, S)]
    cs = max(d for d in range(1, chunk_size + 1) if S % d == 0)
    return [slice(c, c + cs) for c in range(0, S, cs)]


def _chunk(tokens_list: Sequence[torch.Tensor], views: slice) -> List[torch.Tensor]:
    return [t[:, views] for t in tokens_list]


class IGGT(nn.Module):
    """VGGT + instance grounding."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg.aggregator.with_vit(), torch_dtype(cfg.trunk_dtype))
        self.camera_head = CameraHead(cfg.camera)
        head_dtype = torch_dtype(cfg.head_dtype)
        self.point_head = DPTHead(cfg.point_head, head_dtype)
        self.depth_head = DPTHead(cfg.depth_head, head_dtype)
        p = cfg.part
        self.part_adaptor = SamProjector(p.dim_in, p.patch_size, p.intermediate_layer_idx,
                                         p.out_channels, head_dtype)
        self.part_head = PartHead(p, head_dtype)

    def forward(self, images: torch.Tensor,
                fused_ln: bool = False) -> Dict[str, Union[torch.Tensor, list]]:
        """images: (B, S, H, W, 3) in [0, 1]."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        tokens_list, psi = self.aggregator(images, fused_ln)
        pose_list = self.camera_head(tokens_list[-1])
        preds: Dict[str, Union[torch.Tensor, list]] = {
            "pose_enc": pose_list[-1], "pose_enc_list": pose_list}

        outs = [self.depth_head(_chunk(tokens_list, v), (H, W), psi)
                for v in _view_chunks(S, cfg.depth_head.frames_chunk_size)]
        preds["depth"] = torch.cat([o[0] for o in outs], dim=1)
        preds["depth_conf"] = torch.cat([o[1] for o in outs], dim=1)

        outs = [self.point_head(_chunk(tokens_list, v), (H, W), psi)
                for v in _view_chunks(S, cfg.point_head.frames_chunk_size)]
        preds["world_points"] = torch.cat([o[0] for o in outs], dim=1)
        preds["world_points_conf"] = torch.cat([o[1] for o in outs], dim=1)
        # the fusion pyramid, (B*cs, h, w, c) per chunk -> (B, S, h, w, c) per level
        levels = [torch.cat([o[2][i].reshape(B, -1, *o[2][i].shape[1:]) for o in outs], dim=1)
                  for i in range(3)]
        del outs

        feats = []
        for v in _view_chunks(S, cfg.part.frames_chunk_size):
            toks = _chunk(tokens_list, v)
            cs = toks[0].shape[1]
            proj = self.part_adaptor(toks, (H, W), psi)
            pyr = [t[:, v].reshape(B * cs, *t.shape[2:]) for t in levels]
            feats.append(self.part_head(proj, pyr, (H, W), (B, cs)))
        preds["part_feat"] = torch.cat(feats, dim=1)
        return preds


def build_model(cfg: Optional[ModelConfig] = None,
                device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> IGGT:
    """IGGT on ``device`` (the card unless the caller asks for another),
    randomly initialized from ``seed`` (no init on the "meta" device), in
    eval mode with gradients off."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = IGGT(cfg or ModelConfig())
    if dev.type != "meta":
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval().requires_grad_(False)
