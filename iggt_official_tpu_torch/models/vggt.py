"""VGGT / IGGT model assembly.

Counterpart of `iggt_official_tpu/models/vggt.py` (`VGGT`, `IGGT`,
`build_model`): aggregator -> camera head, depth head, point head (which in
IGGT also emits its fusion pyramid), SamProjector + PartHead (IGGT), and the
track head, each behind its ``ModelConfig.enable_*`` switch (the track head
also needs query points).  The trunk runs in ``cfg.trunk_dtype`` (bf16); the
depth, point and part decode paths compute in ``cfg.head_dtype`` (fp32 by
default, bf16 as the fast mode), the camera head and the track head in fp32.
``forward(images, fused_ln=True)`` runs the trunk's pre-norms through the
fused LayerNorm kernel and ``global_merge_r > 0`` merges that many K/V tokens
out of every global block (`ops/token_merge.py`), as the JAX package takes
both at apply time.
Outputs are channels-last: depth (B,S,H,W,1), world_points (B,S,H,W,3),
part_feat (B,S,H,W,8), pose_enc (B,S,9); with query points (B, N, 2) in
pixels, track (B,S,N,2) (the last iteration's), vis and conf (B,S,N).

The dense heads decode views in chunks of at most ``frames_chunk_size``
(the largest divisor of S within the bound), a Python loop here, so their
full-resolution fp32 activations are bounded by the chunk, not by S.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.heads.adaptor import SamProjector
from iggt_official_tpu_torch.heads.camera_head import CameraHead
from iggt_official_tpu_torch.heads.dpt_head import DPTHead
from iggt_official_tpu_torch.heads.part_head import PartHead
from iggt_official_tpu_torch.heads.track import TrackHead
from iggt_official_tpu_torch.models.aggregator import Aggregator
from iggt_official_tpu_torch.utils.device import resolve_device, torch_dtype
from iggt_official_tpu_torch.utils.init import init_params

Preds = Dict[str, Union[torch.Tensor, list, tuple]]


def _view_chunks(S: int, chunk_size: int) -> List[slice]:
    """View slices of the largest chunk that divides S within ``chunk_size``
    (all S views at once when S fits or the bound is 0)."""
    if not chunk_size or S <= chunk_size:
        return [slice(0, S)]
    cs = max(d for d in range(1, chunk_size + 1) if S % d == 0)
    return [slice(c, c + cs) for c in range(0, S, cs)]


def _chunk(tokens_list: Sequence[torch.Tensor], views: slice) -> List[torch.Tensor]:
    return [t[:, views] for t in tokens_list]


class VGGT(nn.Module):
    """Pose + depth + point (+ track) model."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        head_dtype = torch_dtype(cfg.head_dtype)
        self.aggregator = Aggregator(cfg.aggregator.with_vit(), torch_dtype(cfg.trunk_dtype))
        if cfg.enable_camera:
            self.camera_head = CameraHead(cfg.camera)
        if cfg.enable_point:
            self.point_head = DPTHead(cfg.point_head, head_dtype)
        if cfg.enable_depth:
            self.depth_head = DPTHead(cfg.depth_head, head_dtype)
        if cfg.enable_track:
            self.track_head = TrackHead(cfg.track)

    def _dense(self, head: DPTHead, tokens_list, hw: Tuple[int, int], psi: int):
        """A DPT head over view chunks: (preds, conf) concatenated over views,
        and the chunks' fusion pyramids when the head emits one."""
        outs = [head(_chunk(tokens_list, v), hw, psi)
                for v in _view_chunks(tokens_list[0].shape[1], head.cfg.frames_chunk_size)]
        dense = (torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1))
        return dense, [o[2] for o in outs if len(o) == 3]

    def _heads(self, preds: Preds, tokens_list, hw, psi: int,
               query_points: Optional[torch.Tensor]) -> list:
        """Camera, depth, point and track outputs into ``preds``; returns the
        point head's per-chunk fusion pyramids (empty unless it emits them)."""
        cfg = self.cfg
        if cfg.enable_camera:
            pose_list = self.camera_head(tokens_list[-1])
            preds["pose_enc"] = pose_list[-1]
            preds["pose_enc_list"] = pose_list
        if cfg.enable_depth:
            (preds["depth"], preds["depth_conf"]), _ = self._dense(
                self.depth_head, tokens_list, hw, psi)
        pyramids = []
        if cfg.enable_point:
            (preds["world_points"], preds["world_points_conf"]), pyramids = self._dense(
                self.point_head, tokens_list, hw, psi)
        if cfg.enable_track and query_points is not None:
            coord_preds, vis, conf = self.track_head(tokens_list, hw, psi, query_points)
            preds["track"] = coord_preds[-1]
            preds["vis"] = vis
            if conf is not None:
                preds["conf"] = conf
        return pyramids

    def forward(self, images: torch.Tensor, query_points: Optional[torch.Tensor] = None,
                fused_ln: bool = False, global_merge_r: int = 0,
                feat_only: bool = False) -> Preds:
        """images: (B, S, H, W, 3) in [0, 1].  ``feat_only``: the last
        aggregated token map (``cam_token``), the raw (preds, conf) pairs of
        the depth and point heads and the images; no camera, no tracking."""
        B, S, H, W, _ = images.shape
        tokens_list, psi = self.aggregator(images, fused_ln, global_merge_r)
        if feat_only:
            return {"cam_token": tokens_list[-1],
                    "depth": self._dense(self.depth_head, tokens_list, (H, W), psi)[0],
                    "point": self._dense(self.point_head, tokens_list, (H, W), psi)[0],
                    "images": images}
        preds: Preds = {}
        self._heads(preds, tokens_list, (H, W), psi, query_points)
        return preds


class IGGT(VGGT):
    """VGGT + instance grounding: the point head's fusion pyramid and a
    SamProjector feed the PartHead's 8-D instance features."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        if cfg.enable_part:
            if not cfg.enable_point:
                raise ValueError("the part head needs the point head's pyramid")
            p = cfg.part
            head_dtype = torch_dtype(cfg.head_dtype)
            self.part_adaptor = SamProjector(p.dim_in, p.patch_size, p.intermediate_layer_idx,
                                             p.out_channels, head_dtype)
            self.part_head = PartHead(p, head_dtype)

    def forward(self, images: torch.Tensor, query_points: Optional[torch.Tensor] = None,
                fused_ln: bool = False, global_merge_r: int = 0) -> Preds:
        """images: (B, S, H, W, 3) in [0, 1]; query_points (B, N, 2) pixels."""
        cfg = self.cfg
        B, S, H, W, _ = images.shape
        tokens_list, psi = self.aggregator(images, fused_ln, global_merge_r)
        preds: Preds = {}
        pyramids = self._heads(preds, tokens_list, (H, W), psi, query_points)
        if not cfg.enable_part:
            return preds
        # the fusion pyramid, (B*cs, h, w, c) per chunk -> (B, S, h, w, c) per level
        levels = [torch.cat([pyr[i].reshape(B, -1, *pyr[i].shape[1:]) for pyr in pyramids],
                            dim=1) for i in range(3)]
        del pyramids
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
                seed: int = 0) -> VGGT:
    """IGGT (``cfg.name == "iggt"``) or VGGT on ``device`` (the card unless
    the caller asks for another), randomly initialized from ``seed`` (no init
    on the "meta" device), in eval mode with gradients off."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    with torch.device(dev):
        model = IGGT(cfg) if cfg.name == "iggt" else VGGT(cfg)
    if dev.type != "meta":
        init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval().requires_grad_(False)
