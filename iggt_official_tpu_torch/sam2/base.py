"""SAM2Base: the SAM2 model core (counterpart of `iggt_official_tpu/sam2/base.py`,
`sam2/modeling/sam2_base.py:28-907`).

Holds every learned component under the reference checkpoint's names (image
encoder, prompt encoder, mask decoder with its high-res projections, memory
attention, memory encoder, the no-memory / no-object / temporal embeddings)
and the model's steps: `forward_image`, `forward_sam_heads` (the image
path), and `no_memory_features`, `memory_tpos`, `downsample_mask_input`,
`condition_on_memory`, `propagate_step`, `encode_new_memory` (the video
path's steps, which `video_predictor.SAM2VideoPredictor` drives).

Token layout (B, N, C), maps NHWC (the reference is sequence-first).  Mask
logits are resized by align-corners bilinear interpolation, as the JAX
package does (upstream: align_corners=False).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from iggt_official_tpu_torch.ops.conv import Conv2d
from iggt_official_tpu_torch.ops.interpolate import bilinear_resize_align_corners
from iggt_official_tpu_torch.sam2.common import MLP
from iggt_official_tpu_torch.sam2.config import SAM2Config
from iggt_official_tpu_torch.sam2.hiera import ImageEncoder
from iggt_official_tpu_torch.sam2.memory import MemoryAttention, MemoryEncoder
from iggt_official_tpu_torch.sam2.sam_heads import MaskDecoder, PromptEncoder

NO_OBJ_SCORE = -1024.0


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    pos_embed = pos[..., None] / dim_t
    return torch.cat([pos_embed.sin(), pos_embed.cos()], dim=-1)


class SAM2Base(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(
            embed_dim=cfg.d_model,
            image_embedding_size=(cfg.image_size // 16, cfg.image_size // 16),
            input_image_size=(cfg.image_size, cfg.image_size), mask_in_chans=16)
        self.sam_mask_decoder = MaskDecoder(
            transformer_dim=cfg.d_model,
            use_high_res_features=cfg.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=cfg.iou_prediction_use_sigmoid,
            pred_obj_scores=cfg.pred_obj_scores, pred_obj_scores_mlp=cfg.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=cfg.use_multimask_token_for_obj_ptr,
            dynamic_multimask_via_stability=True)
        self.memory_attention = MemoryAttention(
            d_model=cfg.d_model, num_layers=cfg.memory_attention_layers,
            dim_feedforward=cfg.memory_attention_dim_feedforward,
            rope_theta=cfg.memory_attention_rope_theta, kv_in_dim=cfg.memory_kv_in_dim)
        self.memory_encoder = MemoryEncoder(out_dim=cfg.mem_dim, in_dim=cfg.d_model)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, cfg.d_model))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, cfg.d_model))
        if cfg.pred_obj_scores and cfg.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, cfg.d_model))
        if cfg.no_obj_embed_spatial:
            self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, cfg.mem_dim))
        if cfg.use_obj_ptrs_in_encoder:
            self.mask_downsample = Conv2d(1, 1, 4, stride=4)
            self.obj_ptr_proj = (MLP(cfg.d_model, cfg.d_model, cfg.d_model, 3)
                                 if cfg.use_mlp_for_obj_ptr_proj
                                 else nn.Linear(cfg.d_model, cfg.d_model))
        if cfg.proj_tpos_enc_in_obj_ptrs:
            self.obj_ptr_tpos_proj = nn.Linear(cfg.d_model, cfg.mem_dim)

    # ------------------------------------------------------------------
    def forward_image(self, images: torch.Tensor) -> Dict[str, object]:
        """images (B, H, W, 3) -> the backbone dict, the two high-res levels
        projected by the decoder's conv_s0 / conv_s1 (`sam2_base.py:461-474`)."""
        out = self.image_encoder(images)
        if self.cfg.use_high_res_features_in_sam:
            fpn = list(out["backbone_fpn"])
            fpn[0] = self.sam_mask_decoder.conv_s0(fpn[0])
            fpn[1] = self.sam_mask_decoder.conv_s1(fpn[1])
            out["backbone_fpn"] = fpn
        return out

    forward = forward_image

    # ------------------------------------------------------------------
    def forward_sam_heads(self, backbone_features: torch.Tensor,
                          point_inputs: Optional[Dict[str, torch.Tensor]] = None,
                          mask_inputs: Optional[torch.Tensor] = None,
                          high_res_features: Optional[Sequence[torch.Tensor]] = None,
                          multimask_output: bool = False):
        """`sam2_base.py:251-408`.  backbone_features (B, h, w, C); mask_inputs
        (B, H', W', 1).  Returns (low_res_multimasks, high_res_multimasks,
        ious, low_res_masks, high_res_masks, obj_ptr, object_score_logits),
        masks (B, M, H, W)."""
        cfg = self.cfg
        B, h, w, _ = backbone_features.shape
        dev = backbone_features.device
        if point_inputs is not None:
            coords, labels = point_inputs["point_coords"], point_inputs["point_labels"]
        else:
            coords = torch.zeros((B, 1, 2), device=dev)
            labels = -torch.ones((B, 1), dtype=torch.int32, device=dev)
        sam_mask_prompt = None
        if mask_inputs is not None:
            sam_mask_prompt = mask_inputs.float()
            if tuple(mask_inputs.shape[1:3]) != (4 * h, 4 * w):
                sam_mask_prompt = bilinear_resize_align_corners(sam_mask_prompt, (4 * h, 4 * w))
        sparse, dense = self.sam_prompt_encoder(points=(coords, labels), boxes=None,
                                                masks=sam_mask_prompt)
        low_multi, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            image_embeddings=backbone_features,
            image_pe=self.sam_prompt_encoder.get_dense_pe(),
            sparse_prompt_embeddings=sparse, dense_prompt_embeddings=dense,
            multimask_output=multimask_output, high_res_features=high_res_features)
        if cfg.pred_obj_scores:
            low_multi = torch.where(obj_logits[:, :, None, None] > 0, low_multi,
                                    torch.full_like(low_multi, NO_OBJ_SCORE))
        low_multi = low_multi.float()
        hi_multi = bilinear_resize_align_corners(
            low_multi.permute(0, 2, 3, 1), (cfg.image_size, cfg.image_size)).permute(0, 3, 1, 2)
        sam_token = sam_tokens[:, 0]
        if multimask_output:
            best = ious.argmax(-1)
            bidx = torch.arange(B, device=dev)
            low_res_masks = low_multi[bidx, best][:, None]
            high_res_masks = hi_multi[bidx, best][:, None]
            if sam_tokens.shape[1] > 1:
                sam_token = sam_tokens[bidx, best]
        else:
            low_res_masks, high_res_masks = low_multi, hi_multi
        obj_ptr = self.obj_ptr_proj(sam_token)
        if cfg.pred_obj_scores:
            lam = (obj_logits > 0).float()
            if cfg.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            obj_ptr = obj_ptr + (1 - lam) * self.no_obj_ptr
        return low_multi, hi_multi, ious, low_res_masks, high_res_masks, obj_ptr, obj_logits

    # ------------------------------------------------------------------
    def condition_on_memory(self, curr_feats, curr_pos, memory, memory_pos,
                            num_obj_ptr_tokens: int = 0, key_mask=None):
        """Memory-attention fusion (`sam2_base.py:648-671`); ``key_mask`` marks
        the valid tokens of a memory bank padded to a fixed shape."""
        return self.memory_attention(curr_feats, memory, curr_pos, memory_pos,
                                     num_obj_ptr_tokens=num_obj_ptr_tokens, key_mask=key_mask)

    def no_memory_features(self, curr_feats: torch.Tensor) -> torch.Tensor:
        """Initial-frame path (`sam2_base.py:652-658`, directly_add_no_mem_embed)."""
        return curr_feats + self.no_mem_embed

    def memory_tpos(self, t_pos_rel: torch.Tensor) -> torch.Tensor:
        """maskmem temporal embedding rows (n, mem_dim) for relative positions."""
        return self.maskmem_tpos_enc[t_pos_rel][:, 0, 0]

    def downsample_mask_input(self, mask: torch.Tensor) -> torch.Tensor:
        """Stride-4 learned downsample of NHWC mask prompts (`sam2_base.py:104`)."""
        return self.mask_downsample(mask)

    def obj_ptr_tpos(self, pos_norm: torch.Tensor) -> torch.Tensor:
        """Temporal sine embedding of object pointers (`sam2_base.py:622-631`)."""
        cfg = self.cfg
        dim = cfg.d_model if cfg.proj_tpos_enc_in_obj_ptrs else cfg.mem_dim
        enc = get_1d_sine_pe(pos_norm, dim)
        return self.obj_ptr_tpos_proj(enc) if cfg.proj_tpos_enc_in_obj_ptrs else enc

    # ------------------------------------------------------------------
    def propagate_step(self, feats_map, curr_pos, high_res_features, mem_slots, pos_slots,
                       tpos_idx, slot_valid, obj_ptrs, ptr_pos_norm, n_valid_ptrs,
                       multimask_output: bool = False):
        """One non-conditioning tracking step: memory-bank assembly (temporal
        embeddings, pointer tokens, validity masks), memory attention, SAM
        heads and memory encoding (`sam2_base.py:491-729`).  Returns
        (low_res_masks, obj_ptr, object_score_logits, mem_feats, mem_pos)."""
        cfg = self.cfg
        B, h, w, C = feats_map.shape
        curr = feats_map.reshape(B, h * w, C)
        md = cfg.mem_dim
        hw_mem = mem_slots[0].shape[1]
        rows = self.maskmem_tpos_enc[tpos_idx][:, 0, 0]              # (n_slots, md)
        mem = torch.cat(list(mem_slots), dim=1)
        pos = torch.cat([p + r[None, None] for p, r in zip(pos_slots, rows)], dim=1)
        spatial_mask = slot_valid.repeat_interleave(hw_mem)[None]
        if cfg.use_obj_ptrs_in_encoder:
            split = max(cfg.d_model // md, 1)
            ptrs = torch.stack(list(obj_ptrs))[None] if isinstance(obj_ptrs, (tuple, list)) \
                else obj_ptrs
            max_ptrs = ptrs.shape[1]
            n_ptr_tokens = max_ptrs * split
            ptr_tokens = ptrs.reshape(ptrs.shape[0], n_ptr_tokens, md)
            enc = (self.obj_ptr_tpos(ptr_pos_norm) if cfg.add_tpos_enc_to_obj_ptrs
                   else ptr_tokens.new_zeros((max_ptrs, md)))
            ptr_pos = enc.repeat_interleave(split, dim=0)[None].expand(
                ptr_tokens.shape[0], n_ptr_tokens, md)
            ptr_mask = (torch.arange(n_ptr_tokens, device=curr.device)
                        < n_valid_ptrs * split)[None]
            memory = torch.cat([mem, ptr_tokens], dim=1)
            memory_pos = torch.cat([pos, ptr_pos], dim=1)
            key_mask = torch.cat([spatial_mask, ptr_mask], dim=1)
        else:
            n_ptr_tokens = 0
            memory, memory_pos, key_mask = mem, pos, spatial_mask
        fused = self.memory_attention(curr, memory, curr_pos, memory_pos,
                                      num_obj_ptr_tokens=n_ptr_tokens,
                                      key_mask=key_mask).reshape(B, h, w, C)
        (_, _, _, low_res_masks, high_res_masks, obj_ptr,
         obj_logits) = self.forward_sam_heads(fused, None, None, high_res_features,
                                              multimask_output)
        mem_feats, mem_pos = self.encode_new_memory(
            feats_map, high_res_masks.permute(0, 2, 3, 1), obj_logits)
        return low_res_masks, obj_ptr, obj_logits, mem_feats, mem_pos

    def encode_new_memory(self, pix_feat: torch.Tensor, pred_masks_high_res: torch.Tensor,
                          object_score_logits: torch.Tensor):
        """`sam2_base.py:672-729`: pix_feat (B, h, w, C), masks (B, 16h, 16w, 1)."""
        cfg = self.cfg
        mask_for_mem = (torch.sigmoid(pred_masks_high_res) * cfg.sigmoid_scale_for_mem_enc
                        + cfg.sigmoid_bias_for_mem_enc)
        out = self.memory_encoder(pix_feat, mask_for_mem, skip_mask_sigmoid=True)
        feats, pos = out["vision_features"], out["vision_pos_enc"][-1]
        if cfg.no_obj_embed_spatial:
            is_obj = (object_score_logits > 0).float()
            feats = feats + (1 - is_obj[..., None, None]) * self.no_obj_embed_spatial[None]
        return feats, pos


def high_res_features(backbone: Dict[str, object], cfg: SAM2Config) -> Optional[List]:
    return list(backbone["backbone_fpn"][:2]) if cfg.use_high_res_features_in_sam else None
