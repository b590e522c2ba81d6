"""SAM prompt encoder, two-way transformer and mask decoder (counterpart of
`iggt_official_tpu/sam2/sam_heads.py`).

- `PromptEncoder` (`sam2/modeling/sam/prompt_encoder.py:11-199`): random
  Fourier point / box embeddings plus per-label embeddings, the mask
  downscaling conv stack, the dense no-mask embedding.
- `TwoWayTransformer` / `TwoWayAttentionBlock` / `DownsampleAttention`
  (`sam/transformer.py:13-244`): tokens <-> image two-way attention with
  projection downsampling, post-norm residuals.  Its attentions are small
  (at most 7 tokens on one side) and stay plain torch, as they are plain
  einsum + softmax in the JAX package.
- `MaskDecoder` (`sam/mask_decoder.py:9-289`): output tokens, transformer,
  upscaling with the high-res features, hypernetwork mask heads, IoU and
  object-score heads, dynamic multimask via stability.  It holds the
  high-res projections ``conv_s0`` / ``conv_s1`` (reference names), which
  `SAM2Base.forward_image` applies.

Dense maps NHWC.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.layers.blocks import LayerNorm
from iggt_official_tpu_torch.ops.conv import Conv2d, ConvTranspose2d
from iggt_official_tpu_torch.sam2.common import MLP, LayerNorm2d, gelu


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier position encoding (`position_encoding.py:127-170`)."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.randn(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords01 in [0, 1], (..., 2) -> (..., 2 * num_pos_feats)."""
        c = (2 * coords01.float() - 1) @ self.positional_encoding_gaussian_matrix
        c = 2 * math.pi * c
        return torch.cat([c.sin(), c.cos()], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """(h, w, C) dense grid embedding at the pixel centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        return self(torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        c4 = mask_in_chans // 4
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, c4, 2, stride=2), LayerNorm2d(c4), nn.GELU(approximate="tanh"),
            Conv2d(c4, mask_in_chans, 2, stride=2), LayerNorm2d(mask_in_chans),
            nn.GELU(approximate="tanh"), Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        return self.pe_layer.grid(*self.image_embedding_size)   # (h, w, C)

    def _normalized(self, coords: torch.Tensor) -> torch.Tensor:
        H, W = self.input_image_size
        return coords / torch.tensor([W, H], dtype=torch.float32, device=coords.device)

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool) -> torch.Tensor:
        points = points.float() + 0.5
        if pad:
            B = points.shape[0]
            points = torch.cat([points, points.new_zeros((B, 1, 2))], dim=1)
            labels = torch.cat([labels, -labels.new_ones((B, 1))], dim=1)
        emb = self.pe_layer(self._normalized(points))
        lab = labels[..., None]
        emb = torch.where(lab == -1, torch.zeros_like(emb) + self.not_a_point_embed.weight[0],
                          emb)
        for i, table in enumerate(self.point_embeddings):
            emb = torch.where(lab == i, emb + table.weight[0], emb)
        return emb

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        coords = (boxes.float() + 0.5).reshape(-1, 2, 2)
        emb = self.pe_layer(self._normalized(coords))
        return torch.stack([emb[:, 0] + self.point_embeddings[2].weight[0],
                            emb[:, 1] + self.point_embeddings[3].weight[0]], dim=1)

    def forward(self, points=None, boxes=None, masks=None):
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        elif masks is not None:
            bs = masks.shape[0]
        else:
            bs = 1
        dev = self.no_mask_embed.weight.device
        sparse = torch.zeros((bs, 0, self.embed_dim), device=dev)
        if points is not None:
            coords, labels = points
            sparse = torch.cat([sparse, self._embed_points(coords, labels, pad=boxes is None)],
                               dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        if masks is not None:   # (B, 4h, 4w, 1) -> (B, h, w, C)
            dense = self.mask_downscaling(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight[0].expand(bs, h, w, self.embed_dim)
        return sparse, dense


class DownsampleAttention(nn.Module):
    """SAM attention with projection downsampling (`sam/transformer.py:184-244`)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        self.internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal)
        self.k_proj = nn.Linear(embedding_dim, self.internal)
        self.v_proj = nn.Linear(embedding_dim, self.internal)
        self.out_proj = nn.Linear(self.internal, embedding_dim)

    def forward(self, q, k, v):
        hd = self.internal // self.num_heads
        B, Nq = q.shape[:2]
        qh = self.q_proj(q).reshape(B, Nq, self.num_heads, hd)
        kh = self.k_proj(k).reshape(B, -1, self.num_heads, hd)
        vh = self.v_proj(v).reshape(B, -1, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * hd ** -0.5
        probs = torch.softmax(logits.float(), -1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, Nq, self.internal)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampleAttention(embedding_dim, num_heads)
        self.norm1 = LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(embedding_dim)
        self.mlp = MLP(embedding_dim, mlp_dim, embedding_dim, 2)
        self.norm3 = LayerNorm(embedding_dim)
        self.norm4 = LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, embedding_dim: int, num_heads: int, mlp_dim: int,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = DownsampleAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, h, w, C); point_embedding (B, N, C)."""
        B, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(B, h * w, C)
        key_pe = image_pe.reshape(B, h * w, C)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 use_high_res_features: bool = False, iou_prediction_use_sigmoid: bool = False,
                 dynamic_multimask_via_stability: bool = False,
                 dynamic_multimask_stability_delta: float = 0.05,
                 dynamic_multimask_stability_thresh: float = 0.98,
                 pred_obj_scores: bool = False, pred_obj_scores_mlp: bool = False,
                 use_multimask_token_for_obj_ptr: bool = False):
        super().__init__()
        D = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.use_high_res_features = use_high_res_features
        self.dynamic_multimask_via_stability = dynamic_multimask_via_stability
        self.stability_delta = dynamic_multimask_stability_delta
        self.stability_thresh = dynamic_multimask_stability_thresh
        self.pred_obj_scores = pred_obj_scores
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr
        self.transformer = TwoWayTransformer(depth=2, embedding_dim=D, num_heads=8,
                                             mlp_dim=2048)
        self.iou_token = nn.Embedding(1, D)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, D)
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, D)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(D, D // 4, 2, stride=2), LayerNorm2d(D // 4),
            nn.GELU(approximate="tanh"), ConvTranspose2d(D // 4, D // 8, 2, stride=2),
            nn.GELU(approximate="tanh"))
        if use_high_res_features:
            self.conv_s0 = Conv2d(D, D // 8, 1)
            self.conv_s1 = Conv2d(D, D // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(D, D, D // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(D, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth, sigmoid_output=iou_prediction_use_sigmoid)
        if pred_obj_scores:
            self.pred_obj_score_head = (MLP(D, D, 1, 3) if pred_obj_scores_mlp
                                        else nn.Linear(D, 1))

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor, dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool,
                high_res_features: Optional[List[torch.Tensor]] = None):
        """image_embeddings (B, h, w, C), image_pe (h, w, C) -> (masks (B, M, 4h, 4w),
        iou (B, M), SAM output tokens, object score logits (B, 1))."""
        tokens = [self.iou_token.weight, self.mask_tokens.weight]
        s = 0
        if self.pred_obj_scores:
            tokens.insert(0, self.obj_score_token.weight)
            s = 1
        output_tokens = torch.cat(tokens)
        B = sparse_prompt_embeddings.shape[0]
        tokens = torch.cat([output_tokens[None].expand((B,) + output_tokens.shape),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings + dense_prompt_embeddings
        pos_src = image_pe[None].expand(src.shape)
        b, h, w, c = src.shape
        hs, src_out = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]

        src_map = src_out.reshape(b, h, w, c)
        dc1, ln1, _, dc2, _ = self.output_upscaling
        if not self.use_high_res_features:
            up = gelu(dc2(gelu(ln1(dc1(src_map)))))
        else:
            feat_s0, feat_s1 = high_res_features
            up = gelu(ln1(dc1(src_map) + feat_s1))
            up = gelu(dc2(up) + feat_s0)
        hyper = torch.stack([mlp(mask_tokens_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("btc,bhwc->bthw", hyper, up)
        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            object_score_logits = 10.0 * iou_pred.new_ones((B, 1))

        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
        elif self.dynamic_multimask_via_stability:
            out_masks, out_iou = self._dynamic_multimask(masks, iou_pred)
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return out_masks, out_iou, sam_tokens_out, object_score_logits

    def _stability(self, mask_logits: torch.Tensor) -> torch.Tensor:
        flat = mask_logits.flatten(-2)
        d = self.stability_delta
        area_i = (flat > d).sum(-1).float()
        area_u = (flat > -d).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_u))

    def _dynamic_multimask(self, all_masks: torch.Tensor, all_iou: torch.Tensor):
        multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
        best = multi_iou.argmax(-1)
        bidx = torch.arange(multi.shape[0], device=multi.device)
        best_masks = multi[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single, single_iou = all_masks[:, 0:1], all_iou[:, 0:1]
        stable = self._stability(single) >= self.stability_thresh
        masks = torch.where(stable[..., None, None], single, best_masks)
        iou = torch.where(stable, single_iou, best_iou)
        return masks, iou
