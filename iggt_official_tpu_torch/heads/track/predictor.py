"""Iterative track refinement.

Counterpart of `iggt_official_tpu/heads/track/predictor.py`
(`BaseTrackerPredictor`): tracks start at the query points in every view;
each iteration samples the correlation pyramid around them, embeds the
flow from view 0, adds the track features and a sampled positional
embedding, and the EfficientUpdateFormer predicts coordinate and feature
updates; view 0 is reset to the query points after every update.
Visibility and confidence are sigmoid heads on the last track features.
fp32 throughout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.config import TrackHeadConfig
from iggt_official_tpu_torch.heads.track.corr import build_pyramid, corr_sample
from iggt_official_tpu_torch.heads.track.modules import EfficientUpdateFormer
from iggt_official_tpu_torch.heads.track.sampling import (
    bilinear_sample_nhwc,
    get_2d_embedding,
    get_2d_sincos_pos_embed,
)
from iggt_official_tpu_torch.layers.blocks import LayerNorm, Linear, Mlp


class BaseTrackerPredictor(nn.Module):
    """fmaps (B, S, H', W', C) + query points (B, N, 2) -> (coordinates per
    iteration, each (B, S, N, 2); visibility (B, S, N); confidence or None)."""

    def __init__(self, cfg: TrackHeadConfig, stride: int = 2, depth: int = 6,
                 max_scale: int = 518):
        super().__init__()
        self.cfg = cfg
        self.stride = stride
        self.max_scale = max_scale
        latent = cfg.features
        self.transformer_dim = 3 * latent + 4
        self.fmap_norm = LayerNorm(latent)
        self.corr_mlp = Mlp(cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2,
                            cfg.hidden_size, latent)
        self.updateformer = EfficientUpdateFormer(
            space_depth=depth, time_depth=depth, input_dim=self.transformer_dim,
            hidden_size=cfg.hidden_size, output_dim=latent + 2)
        self.query_ref_token = nn.Parameter(torch.zeros(1, 2, self.transformer_dim))
        # GroupNorm with one group over (rows, latent) is a LayerNorm over latent
        self.ffeat_norm = LayerNorm(latent)
        self.ffeat_updater = nn.Sequential(Linear(latent, latent), nn.GELU())  # erf GELU
        self.vis_predictor = nn.Sequential(Linear(latent, 1))
        self.conf_predictor = nn.Sequential(Linear(latent, 1)) if cfg.predict_conf else None

    def forward(self, query_points: torch.Tensor, fmaps: torch.Tensor,
                iters: Optional[int] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        iters = iters or cfg.iters
        latent, tdim = cfg.features, self.transformer_dim
        B, N, _ = query_points.shape
        _, S, HH, WW, _ = fmaps.shape

        fmaps = self.fmap_norm(fmaps)
        query_points = query_points.float() / float(self.stride)
        coords = query_points[:, None].expand(B, S, N, 2)             # (B, S, N, 2)
        coords0 = query_points
        track_feats = bilinear_sample_nhwc(fmaps[:, 0], query_points)[:, None].expand(
            B, S, N, latent)
        pyramid, scales = build_pyramid(fmaps, cfg.corr_levels)
        pos_grid = get_2d_sincos_pos_embed(tdim, (HH, WW), fmaps.device).expand(
            B, HH, WW, tdim)
        qr = torch.cat([self.query_ref_token[:, 0:1],
                        self.query_ref_token[:, 1:2].expand(1, S - 1, tdim)], dim=1)

        coord_preds: List[torch.Tensor] = []
        for _ in range(iters):
            fcorrs = corr_sample(pyramid, scales, track_feats, coords, cfg.corr_radius)
            fcorrs = self.corr_mlp(fcorrs.transpose(1, 2).reshape(B * N, S, -1))

            flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
            flows_emb = torch.cat([get_2d_embedding(flows, latent // 2),
                                   flows / self.max_scale, flows / self.max_scale], dim=-1)
            feats = track_feats.transpose(1, 2).reshape(B * N, S, latent)
            x = torch.cat([flows_emb, fcorrs, feats], dim=-1)
            x = x + bilinear_sample_nhwc(pos_grid, coords[:, 0]).reshape(B * N, 1, tdim)
            x = x + qr
            del fcorrs, flows_emb

            delta = self.updateformer(x.reshape(B, N, S, tdim)).reshape(B * N, S, latent + 2)
            delta_feats = delta[..., 2:].reshape(B * N * S, latent)
            feats = (self.ffeat_updater(self.ffeat_norm(delta_feats))
                     + feats.reshape(B * N * S, latent))
            track_feats = feats.reshape(B, N, S, latent).transpose(1, 2)
            coords = coords + delta[..., :2].reshape(B, N, S, 2).transpose(1, 2)
            coords = torch.cat([coords0[:, None], coords[:, 1:]], dim=1)
            coord_preds.append(coords * self.stride)

        tf = track_feats.reshape(B * S * N, latent)
        vis = torch.sigmoid(self.vis_predictor(tf)).reshape(B, S, N)
        conf = None
        if self.conf_predictor is not None:
            conf = torch.sigmoid(self.conf_predictor(tf)).reshape(B, S, N)
        return coord_preds, vis, conf
