"""SAM2 image predictor (counterpart of `iggt_official_tpu/sam2/image_predictor.py`,
`sam2/sam2_image_predictor.py:14-460`).

`set_image` runs the image encoder once and keeps the backbone features
(the projected high-res levels included) on the model's device; `predict`
maps point / box / mask prompts through the prompt encoder and the mask
decoder and post-processes the masks back to the image's size;
`predict_point_batch` runs a batch of single-point prompts, the automatic
mask generator's sweep, and leaves its logits on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from iggt_official_tpu_torch.sam2.base import SAM2Base, high_res_features
from iggt_official_tpu_torch.sam2.transforms import SAM2Transforms


class SAM2ImagePredictor:
    def __init__(self, model: SAM2Base, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.mask_threshold = mask_threshold
        self._transforms = SAM2Transforms(self.cfg.image_size, mask_threshold, max_hole_area,
                                          max_sprinkle_area)
        self._features = None
        self._orig_hw: Optional[Tuple[int, int]] = None

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: HWC RGB uint8 (or float in [0, 1])."""
        self._orig_hw = tuple(image.shape[:2])
        batch = torch.from_numpy(self._transforms.forward_batch([image])).to(self.device)
        self._features = self.model.forward_image(batch)

    @torch.inference_mode()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False):
        """Returns (masks (M, H, W), iou_predictions (M,), low-res logits (M, h, w)),
        numpy arrays; masks are bool unless ``return_logits``."""
        assert self._features is not None, "call set_image first"
        coords, labels = self._prep_prompts(point_coords, point_labels, box)
        mask_in = None
        if mask_input is not None:
            m = np.asarray(mask_input, np.float32)
            mask_in = torch.from_numpy(m[0] if m.ndim == 3 else m)[None, :, :, None].to(self.device)
        point_inputs = None
        if coords is not None:
            point_inputs = {"point_coords": torch.from_numpy(coords).to(self.device),
                            "point_labels": torch.from_numpy(labels).to(self.device)}
        res = self.model.forward_sam_heads(
            self._features["backbone_fpn"][-1], point_inputs, mask_in,
            high_res_features(self._features, self.cfg), multimask_output)
        low_multi, ious = res[0], res[2]
        masks = self._transforms.postprocess_masks(low_multi, self._orig_hw)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks[0].cpu().numpy(), ious[0].cpu().numpy(), low_multi[0].cpu().numpy()

    @torch.inference_mode()
    def predict_point_batch(self, point_coords: np.ndarray):
        """Single-point prompts, one per row of (N, 2) absolute pixel coords ->
        (multimask logits (N, 3, h, w), ious (N, 3)), tensors on the device."""
        assert self._features is not None, "call set_image first"
        coords = self._transforms.transform_coords(
            np.asarray(point_coords, np.float32), normalize=True, orig_hw=self._orig_hw)[:, None]
        N = coords.shape[0]
        labels = np.ones((N, 1), np.int32)
        feats = self._features["backbone_fpn"][-1]
        hi = high_res_features(self._features, self.cfg)
        if hi is not None:
            hi = [f.expand((N,) + f.shape[1:]) for f in hi]
        res = self.model.forward_sam_heads(
            feats.expand((N,) + feats.shape[1:]),
            {"point_coords": torch.from_numpy(coords).to(self.device),
             "point_labels": torch.from_numpy(labels).to(self.device)},
            None, hi, True)
        return res[0], res[2]

    def _prep_prompts(self, point_coords, point_labels, box):
        coords = labels = None
        if point_coords is not None:
            assert point_labels is not None
            coords = self._transforms.transform_coords(
                np.asarray(point_coords, np.float32), normalize=True,
                orig_hw=self._orig_hw)[None]
            labels = np.asarray(point_labels, np.int32)[None]
        if box is not None:
            box_coords = self._transforms.transform_boxes(
                np.asarray(box, np.float32), normalize=True,
                orig_hw=self._orig_hw).reshape(1, 2, 2)
            box_labels = np.asarray([[2, 3]], np.int32)
            if coords is not None:
                coords = np.concatenate([box_coords, coords], axis=1)
                labels = np.concatenate([box_labels, labels], axis=1)
            else:
                coords, labels = box_coords, box_labels
        return coords, labels
