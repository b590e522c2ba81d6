"""Instance-grounded part-feature head, channels-last.

Counterpart of `iggt_official_tpu/heads/part_head.py`: RefineNet fusion of
the SamProjector pyramid with the point head's fusion pyramid injected by
cross-attention after refinenet4 (level 1x, through the flash kernel), an
overlapping-window cross-attention after refinenet2 (level 4x), refinenet1,
output_conv1, a window self-attention, a bilinear upsample to full
resolution and the output convs.  Computes in ``dtype`` (fp32, or bf16 as the
fast mode, where the cross-attention takes the bf16 flash kernel); returns
raw 8-channel fp32 features.

``cross_attention_1`` keeps its parameters (they are in the checkpoint) but
is not computed: the reference computes it and discards the result.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from iggt_official_tpu_torch.config import PartHeadConfig
from iggt_official_tpu_torch.heads.dpt_head import make_fusion_scratch
from iggt_official_tpu_torch.heads.window_attn import SwinCA, SwinSA
from iggt_official_tpu_torch.layers.blocks import CrossAttention
from iggt_official_tpu_torch.ops.interpolate import bilinear_resize_align_corners


class PartHead(nn.Module):
    """Fuse projector + point features into per-pixel instance embeddings."""

    def __init__(self, cfg: PartHeadConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        f = cfg.features
        self.scratch = make_fusion_scratch(cfg.out_channels, f, cfg.output_dim, dtype)
        self.cross_attention_1 = CrossAttention(f, cfg.ca_num_heads, dtype=dtype)
        self.cross_attention_2 = CrossAttention(f, cfg.ca_num_heads, dtype=dtype)
        self.window_self_atten = SwinSA(f // 2, f // 2, cfg.swin_num_heads, cfg.window_size,
                                        dtype=dtype)
        self.window_cross_attention = SwinCA(f, f, cfg.swin_num_heads, cfg.window_size,
                                             q_window_mode=cfg.q_window_mode, dtype=dtype)

    def forward(self, projector_features: Sequence[torch.Tensor],
                point_features: Sequence[torch.Tensor], images_hw: Tuple[int, int],
                batch_dims: Tuple[int, int], attn_fn: Optional[Callable] = None) -> torch.Tensor:
        """projector_features: 4 NHWC maps (res1..res4), batch B*S;
        point_features: (out2, out3, out4) NHWC, batch B*S.  ``attn_fn``
        replaces the cross-attention's dispatcher for one call (the training
        route).  Returns (B, S, H, W, output_dim)."""
        B, S = batch_dims
        H, W = images_hw
        p = self.cfg.patch_size
        sc = self.scratch
        rn = [getattr(sc, f"layer{i + 1}_rn")(projector_features[i]) for i in range(4)]
        pt2, _pt3, pt4 = (t.to(self.dtype) for t in point_features)

        def flat(x):
            return x.reshape(x.shape[0], -1, x.shape[-1])

        out = sc.refinenet4(rn[3], size=rn[2].shape[1:3])
        out = self.cross_attention_2(flat(out), flat(pt4), flat(pt4),
                                     attn_fn=attn_fn).reshape(out.shape)
        out = sc.refinenet3(out, rn[2], size=rn[1].shape[1:3])
        out = sc.refinenet2(out, rn[1], size=rn[0].shape[1:3])
        out = self.window_cross_attention(out, pt2, pt2)
        out = sc.refinenet1(out, rn[0])
        out = self.window_self_atten(sc.output_conv1(out))
        out = bilinear_resize_align_corners(out, ((H // p) * p, (W // p) * p))
        out = sc.output_conv2(out)
        return out.float().reshape(B, S, *out.shape[1:])
