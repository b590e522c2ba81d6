"""SAM2 model configuration (copy of `iggt_official_tpu/sam2/config.py`).

One dataclass covering `sam2/configs/sam2.1/*.yaml`; the named factories
bind the published sizes (values from `sam2.1_hiera_l.yaml` /
`sam2.1_hiera_b+.yaml`).  Field names and defaults are the JAX package's,
so one config describes the same network in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    """`hieradet.py:163-254` construction knobs."""

    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)

    @property
    def channel_list(self) -> Tuple[int, ...]:
        dims = []
        d = self.embed_dim
        for _ in self.stages:
            dims.append(d)
            d = int(d * self.dim_mul)
        return tuple(dims[::-1])  # coarsest first


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    image_size: int = 1024
    hiera: HieraConfig = dataclasses.field(default_factory=HieraConfig)
    d_model: int = 256
    scalp: int = 1
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    fpn_interp_model: str = "nearest"
    # memory (`sam2.1_hiera_l.yaml:30-90`)
    memory_attention_layers: int = 4
    memory_attention_dim_feedforward: int = 2048
    memory_attention_rope_theta: float = 10000.0
    memory_attention_feat_sizes: Tuple[int, int] = (64, 64)
    memory_kv_in_dim: int = 64
    mem_dim: int = 64
    num_maskmem: int = 7
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    directly_add_no_mem_embed: bool = True
    no_obj_embed_spatial: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    iou_prediction_use_sigmoid: bool = True
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = True
    proj_tpos_enc_in_obj_ptrs: bool = True
    use_signed_tpos_enc_to_obj_ptrs: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    use_mlp_for_obj_ptr_proj: bool = True
    use_mask_input_as_output_without_sam: bool = True

    def scaled(self, embed_dim: int = 16, stages: Tuple[int, ...] = (1, 1, 1, 1),
               image_size: int = 64) -> "SAM2Config":
        """Tiny variant for tests."""
        hiera = dataclasses.replace(
            self.hiera,
            embed_dim=embed_dim,
            num_heads=1,
            stages=stages,
            global_att_blocks=(sum(stages) - 1,),
            window_spec=(4, 4, 4, 4),
            window_pos_embed_bkg_spatial_size=(4, 4),
        )
        return dataclasses.replace(
            self, hiera=hiera, image_size=image_size, d_model=32, mem_dim=16,
            memory_attention_layers=1, memory_attention_dim_feedforward=64,
            memory_attention_feat_sizes=(image_size // 16, image_size // 16),
            memory_kv_in_dim=16,
        )


def _versioned(cfg: SAM2Config, version: str) -> SAM2Config:
    """Apply the v2 / v2.1 split.

    The reference ships every hiera size in two generations whose only
    model-structure differences are the object-pointer temporal encoding
    and the spatial no-object embedding (diff of `sam2/configs/sam2/*.yaml`
    vs `sam2/configs/sam2.1/*.yaml`): v2 has ``add_tpos_enc_to_obj_ptrs:
    false`` (and therefore no tpos projection / signed tpos) and no
    ``no_obj_embed_spatial`` parameter."""
    if version == "2.1":
        return cfg
    if version == "2":
        return dataclasses.replace(
            cfg,
            no_obj_embed_spatial=False,
            add_tpos_enc_to_obj_ptrs=False,
            proj_tpos_enc_in_obj_ptrs=False,
            use_signed_tpos_enc_to_obj_ptrs=False,
        )
    raise ValueError(f"unknown SAM2 version {version!r} (use '2' or '2.1')")


def sam2_hiera_l(version: str = "2.1") -> SAM2Config:
    """`sam2.1_hiera_l.yaml` (default) / `sam2_hiera_l.yaml` sizing."""
    return _versioned(SAM2Config(), version)


def sam2_hiera_b_plus(version: str = "2.1") -> SAM2Config:
    """`sam2.1_hiera_b+.yaml` sizing."""
    return _versioned(
        dataclasses.replace(
            SAM2Config(),
            hiera=HieraConfig(
                embed_dim=112,
                num_heads=2,
                stages=(2, 3, 16, 3),
                global_att_blocks=(12, 16, 20),
                window_pos_embed_bkg_spatial_size=(14, 14),
                window_spec=(8, 4, 14, 7),
            ),
        ),
        version,
    )


def sam2_hiera_s(version: str = "2.1") -> SAM2Config:
    """`sam2.1_hiera_s.yaml` sizing (hiera defaults except stages /
    global-attention block ids / background pos-embed tile)."""
    return _versioned(
        dataclasses.replace(
            SAM2Config(),
            hiera=HieraConfig(
                embed_dim=96,
                num_heads=1,
                stages=(1, 2, 11, 2),
                global_att_blocks=(7, 10, 13),
                window_pos_embed_bkg_spatial_size=(7, 7),
                window_spec=(8, 4, 14, 7),
            ),
        ),
        version,
    )


def sam2_hiera_t(version: str = "2.1") -> SAM2Config:
    """`sam2.1_hiera_t.yaml` sizing."""
    return _versioned(
        dataclasses.replace(
            SAM2Config(),
            hiera=HieraConfig(
                embed_dim=96,
                num_heads=1,
                stages=(1, 2, 7, 2),
                global_att_blocks=(5, 7, 9),
                window_pos_embed_bkg_spatial_size=(7, 7),
                window_spec=(8, 4, 14, 7),
            ),
        ),
        version,
    )


SAM2_PRESETS = {
    "hiera_t": sam2_hiera_t,
    "hiera_s": sam2_hiera_s,
    "hiera_b+": sam2_hiera_b_plus,
    "hiera_l": sam2_hiera_l,
}
