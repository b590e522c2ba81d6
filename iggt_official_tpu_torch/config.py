"""Typed configuration for the port (copy of `iggt_official_tpu/config.py`).

The model dataclasses keep the JAX package's field names and defaults for
everything the port builds, so `ModelConfig().scaled(...)` describes the
same network in both packages.  Fields that select code not ported yet (the
upstream-HAT window partition, the TPU mesh and sky masking) are left out
until that code lands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINOv2-style ViT-L/14 patch embedder with 4 register tokens."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    init_values: float = 1.0  # layerscale
    ln_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Alternating frame/global attention trunk."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24  # pairs of (frame, global) blocks
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    patch_embed: str = "dinov2_vitl14_reg"  # or "conv"
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01  # layerscale for the AA blocks
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    def with_vit(self) -> "AggregatorConfig":
        vit = dataclasses.replace(
            self.vit,
            img_size=self.img_size,
            patch_size=self.patch_size,
            num_register_tokens=self.num_register_tokens,
        )
        return dataclasses.replace(self, vit=vit)


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """DPT dense decoder head."""

    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 4
    activation: str = "inv_log"
    conf_activation: str = "expp1"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    pos_embed: bool = True
    use_point_feat: bool = False
    # the track head's feature extractor: output_conv1 keeps ``features``
    # channels, the map is resized to 1 / down_ratio of the image and
    # returned without output_conv2 or an activation
    down_ratio: int = 1
    for_tracker: bool = False
    # upper bound on views decoded per chunk: the largest divisor of S
    # within it is used (models/vggt.py `_view_chunking`)
    frames_chunk_size: int = 8


@dataclasses.dataclass(frozen=True)
class CameraHeadConfig:
    """Iterative pose regression head."""

    dim_in: int = 2048
    trunk_depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    target_dim: int = 9  # absT(3) + quaR(4) + FoV(2)
    num_iterations: int = 4
    trans_act: str = "linear"
    quat_act: str = "linear"
    fl_act: str = "relu"


@dataclasses.dataclass(frozen=True)
class PartHeadConfig:
    """Instance-feature head."""

    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 8
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 256, 256, 256)
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    window_size: int = 8
    ca_num_heads: int = 8
    swin_num_heads: int = 4
    frames_chunk_size: int = 8


@dataclasses.dataclass(frozen=True)
class TrackHeadConfig:
    """CoTracker-style tracker head."""

    dim_in: int = 2048
    patch_size: int = 14
    features: int = 128
    iters: int = 4
    corr_levels: int = 7
    corr_radius: int = 4
    hidden_size: int = 384
    predict_conf: bool = True
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full IGGT / VGGT model assembly (camera, depth, point, part and track
    heads, each behind its ``enable_*`` switch)."""

    name: str = "iggt"  # "iggt" | "vggt"
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    aggregator: AggregatorConfig = dataclasses.field(default_factory=AggregatorConfig)
    enable_camera: bool = True
    enable_depth: bool = True
    enable_point: bool = True
    enable_part: bool = True
    enable_track: bool = False
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    camera: CameraHeadConfig = dataclasses.field(default_factory=CameraHeadConfig)
    part: PartHeadConfig = dataclasses.field(default_factory=PartHeadConfig)
    track: TrackHeadConfig = dataclasses.field(default_factory=TrackHeadConfig)
    # the trunk runs in trunk_dtype (bf16), LayerNorms and RoPE in fp32; the
    # depth / point / part decode heads compute in head_dtype ("float32" is
    # the reference's autocast-disabled island, "bfloat16" the fast mode);
    # the camera head and the heads' LayerNorms and activations stay fp32
    trunk_dtype: str = "bfloat16"
    head_dtype: str = "float32"
    frames_chunk_size: int = 8

    @property
    def depth_head(self) -> DPTConfig:
        return DPTConfig(
            dim_in=2 * self.embed_dim,
            patch_size=self.patch_size,
            output_dim=2,
            activation="exp",
            conf_activation="expp1",
            intermediate_layer_idx=self.intermediate_layer_idx,
            use_point_feat=False,
            frames_chunk_size=self.frames_chunk_size,
        )

    @property
    def point_head(self) -> DPTConfig:
        return DPTConfig(
            dim_in=2 * self.embed_dim,
            patch_size=self.patch_size,
            output_dim=4,
            activation="inv_log",
            conf_activation="expp1",
            intermediate_layer_idx=self.intermediate_layer_idx,
            use_point_feat=(self.name == "iggt"),
            frames_chunk_size=self.frames_chunk_size,
        )

    def scaled(self, embed_dim: int, depth: int, num_heads: int,
               vit_depth: Optional[int] = None, img_size: int = 518,
               patch_embed: str = "dinov2_vitl14_reg") -> "ModelConfig":
        """A smaller variant (for tests / debug)."""
        vit = ViTConfig(
            img_size=img_size, patch_size=self.patch_size, embed_dim=embed_dim,
            depth=vit_depth if vit_depth is not None else depth,
            num_heads=num_heads,
        )
        agg = AggregatorConfig(
            img_size=img_size, patch_size=self.patch_size, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, patch_embed=patch_embed, vit=vit,
        ).with_vit()
        idx = tuple(sorted({depth // 6, depth // 2, (3 * depth) // 4, depth - 1}))
        while len(idx) < 4:  # tiny depths: repeat the last layer
            idx = idx + (depth - 1,)
        return dataclasses.replace(
            self,
            img_size=img_size,
            embed_dim=embed_dim,
            aggregator=agg,
            intermediate_layer_idx=idx[:4],
            camera=dataclasses.replace(
                self.camera, dim_in=2 * embed_dim,
                num_heads=min(num_heads, 2 * embed_dim // 32)),
            part=dataclasses.replace(
                self.part, dim_in=2 * embed_dim,
                intermediate_layer_idx=idx[:4]),
            track=dataclasses.replace(
                self.track, dim_in=2 * embed_dim,
                intermediate_layer_idx=idx[:4]),
        )


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    """HDBSCAN / KNN post-processing (`demo.py:62-83`, "Large" preset)."""

    eps: float = 0.06
    min_samples: int = 100
    min_cluster_size: int = 500
    knn_k: int = 20
    # exact=True runs the weighted HDBSCAN at full pixel density (the
    # reference algorithm verbatim; minutes at demo scale); False clusters a
    # <=150k uniform subsample with density-scaled parameters
    exact: bool = False


# Presets from demo.py:63-83
CLUSTERING_SMALL = ClusteringConfig(eps=0.005, min_samples=50)
CLUSTERING_MEDIUM = ClusteringConfig(eps=0.01, min_samples=100)
CLUSTERING_LARGE = ClusteringConfig(eps=0.06, min_samples=100)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs for the inference app."""

    image_size: Tuple[int, int] = (504, 336)  # (W, H)
    # GLB export: drop points below this percentile of confidence
    conf_threshold: float = 0.3
    clustering: ClusteringConfig = dataclasses.field(default_factory=ClusteringConfig)
    # every trunk pre-norm through the hand-written LayerNorm kernel
    # (`ops/fused_ln.py`, two-pass variance) instead of the fast-variance
    # `LayerNorm`; off by default, as in the JAX package
    fused_ln: bool = False
    # merge this many K/V tokens out of every global-attention block
    # (`ops/token_merge.py`, the demo's --merge_tokens); 0 = exact attention.
    # Clamped to the unprotected candidates.  Worth it at 32+ views, where
    # the tokens of many views repeat each other.
    global_merge_r: int = 0
