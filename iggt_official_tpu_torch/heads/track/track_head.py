"""Track head: a DPT feature extractor at half resolution feeding the
iterative tracker.

Counterpart of `iggt_official_tpu/heads/track/track_head.py`: a `DPTHead`
with ``for_tracker``, ``down_ratio=2`` and the positional embedding off, in
fp32 whatever the model's head dtype (the JAX package builds it without a
dtype), so the bf16 trunk's tokens go up to fp32 at its entry; then
`BaseTrackerPredictor`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.config import DPTConfig, TrackHeadConfig
from iggt_official_tpu_torch.heads.dpt_head import DPTHead
from iggt_official_tpu_torch.heads.track.predictor import BaseTrackerPredictor


class TrackHead(nn.Module):
    def __init__(self, cfg: TrackHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = DPTHead(DPTConfig(
            dim_in=cfg.dim_in, patch_size=cfg.patch_size, features=cfg.features,
            intermediate_layer_idx=cfg.intermediate_layer_idx, for_tracker=True,
            down_ratio=2, pos_embed=False, frames_chunk_size=0))
        self.tracker = BaseTrackerPredictor(cfg)

    def forward(self, tokens_list: Sequence[torch.Tensor], images_hw: Tuple[int, int],
                patch_start_idx: int, query_points: torch.Tensor,
                iters: Optional[int] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
        fmaps = self.feature_extractor(tokens_list, images_hw, patch_start_idx)
        return self.tracker(query_points, fmaps, iters=iters)
