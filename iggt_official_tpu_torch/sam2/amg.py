"""Automatic mask generation (counterpart of `iggt_official_tpu/sam2/amg.py`,
`sam2/automatic_mask_generator.py:29-447` and `sam2/utils/amg.py`).

A uniform point grid is swept in batches of single-point multimask prompts
(`SAM2ImagePredictor.predict_point_batch`); each batch's masks are
post-processed and filtered by predicted IoU and stability score on the
device, and only the kept masks come to the host, where boxes decide the
crop-edge test, box NMS removes duplicates, and masks are encoded as RLE,
as in the JAX package.  Crop layers beyond the full image
(``crop_n_layers > 0``) run the same pipeline per crop.  The host helpers
are copies of the JAX package's; the small-region removal takes the native
connected components (`ops/connected_components.py`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from iggt_official_tpu_torch.ops.connected_components import (
    connected_components_host, mask_to_box,
)
from iggt_official_tpu_torch.sam2.image_predictor import SAM2ImagePredictor


# ---------------------------------------------------------------------------
# host helpers (`sam2/utils/amg.py`), copied from the JAX package


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalized [0,1] grid (`amg.py:175-183`)."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    gx = np.tile(pts[None, :], (n_per_side, 1))
    gy = np.tile(pts[:, None], (1, n_per_side))
    return np.stack([gx, gy], axis=-1).reshape(-1, 2)


def calculate_stability_score(
    masks: np.ndarray, mask_threshold: float, threshold_offset: float
) -> np.ndarray:
    """IoU between high/low thresholded masks (`amg.py:152-172`)."""
    hi = (masks > (mask_threshold + threshold_offset)).sum(axis=(-2, -1))
    lo = (masks > (mask_threshold - threshold_offset)).sum(axis=(-2, -1))
    return np.where(lo > 0, hi / np.maximum(lo, 1), 1.0)


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) bool -> (..., 4) xyxy, zeros for empty (`amg.py:299-330`)."""
    shape = masks.shape[:-2]
    H, W = masks.shape[-2:]
    flat = masks.reshape((-1, H, W))
    boxes = np.zeros((flat.shape[0], 4), np.float32)
    for i, m in enumerate(flat):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes.reshape(shape + (4,))


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.asarray(box, np.float32).copy()
    out[..., 2] = out[..., 2] - out[..., 0]
    out[..., 3] = out[..., 3] - out[..., 1]
    return out


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Column-major uncompressed RLE (`amg.py:103-131` single-mask)."""
    h, w = mask.shape
    flat = mask.transpose().reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    mask = np.empty(h * w, bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx : idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def build_all_layer_point_grids(
    n_per_side: int, n_layers: int, scale_per_layer: int
) -> List[np.ndarray]:
    """Per-crop-layer grids, layer i downscaled by scale^i (`amg.py:185-193`)."""
    return [
        build_point_grid(max(1, int(n_per_side / (scale_per_layer**i))))
        for i in range(n_layers + 1)
    ]


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """Layered overlapping crop boxes, (2^i)^2 per layer i, plus the full
    image at layer 0 (`sam2/utils/amg.py:196-230` semantics verbatim —
    crop placement must match bit-for-bit for mask parity)."""
    import math

    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len: int, n_crops: int, overlap: int) -> int:
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        for x0 in ((crop_w - overlap) * i for i in range(n_per_side)):
            for y0 in ((crop_h - overlap) * i for i in range(n_per_side)):
                crop_boxes.append(
                    [int(x0), int(y0),
                     min(int(x0) + crop_w, im_w), min(int(y0) + crop_h, im_h)]
                )
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return np.asarray(boxes, np.float32) + np.array(
        [x0, y0, x0, y0], np.float32
    )


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    return np.asarray(points, np.float32) + np.array(
        crop_box[:2], np.float32
    )


def uncrop_masks(
    masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int
) -> np.ndarray:
    """Pad crop-frame masks back to the original frame (`amg.py:251-260`)."""
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    out = np.zeros(masks.shape[:-2] + (orig_h, orig_w), masks.dtype)
    out[..., y0:y1, x0:x1] = masks
    return out


def is_box_near_crop_edge(
    boxes: np.ndarray,
    crop_box: List[int],
    orig_box: List[int],
    atol: float = 20.0,
) -> np.ndarray:
    """True for boxes touching a crop edge that is NOT an image edge
    (`amg.py:74-84`): such masks are fragments of the crop window, and the
    neighbouring overlapping crop sees the whole object."""
    boxes = uncrop_boxes_xyxy(boxes, crop_box)
    near_crop = np.isclose(
        boxes, np.asarray(crop_box, np.float32)[None], atol=atol, rtol=0
    )
    near_image = np.isclose(
        boxes, np.asarray(orig_box, np.float32)[None], atol=atol, rtol=0
    )
    return np.any(near_crop & ~near_image, axis=-1)


def box_area(boxes: np.ndarray) -> np.ndarray:
    return np.maximum(boxes[..., 2] - boxes[..., 0], 0) * np.maximum(
        boxes[..., 3] - boxes[..., 1], 0
    )


def nms_boxes(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> List[int]:
    """Greedy box NMS (torchvision.ops.nms equivalent)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Drop small islands or fill small holes through connected components (`amg.py:263-296`)."""
    assert mode in ("holes", "islands")
    working = (mask == 0) if mode == "holes" else mask
    labels, areas = connected_components_host(working[None])
    small = (labels[0] > 0) & (areas[0] < area_thresh)
    if not small.any():
        return mask, False
    if mode == "holes":
        return mask | small, True
    return mask & ~small, True


# ---------------------------------------------------------------------------


class _CropData:
    """Per-crop accumulator (the reference's MaskData, numpy only)."""

    FIELDS = ("masks", "ious", "stability", "points", "boxes", "crop_boxes")

    def __init__(self):
        for name in self.FIELDS:
            setattr(self, name, [])

    def extend(self, other: "_CropData") -> None:
        for name in self.FIELDS:
            getattr(self, name).extend(getattr(other, name))

    def filter(self, keep) -> None:
        for name in self.FIELDS:
            setattr(self, name, [v for v, k in zip(getattr(self, name), keep) if k])

    def __len__(self) -> int:
        return len(self.masks)


class SAM2AutomaticMaskGenerator:
    def __init__(self, predictor: SAM2ImagePredictor, points_per_side: int = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.8,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 mask_threshold: float = 0.0, box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0, crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1, min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask"):
        self.predictor = predictor
        self.point_grids = build_all_layer_point_grids(
            points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    def _filter_batch(self, low_multi: torch.Tensor, ious: torch.Tensor, hw: Tuple[int, int]):
        """One batch's masks on the device: post-processed to the crop's size,
        kept by predicted IoU and stability score (float64 ratio, as the host
        computes it), binarized; the kept ones come back as numpy with their
        boxes (zeros for an empty mask), IoUs, stability scores and indices
        into the batch's flattened (point, mask) order."""
        masks = self.predictor._transforms.postprocess_masks(low_multi, hw).flatten(0, 1)
        ious = ious.flatten()
        t, off = self.mask_threshold, self.stability_score_offset
        hi = (masks > t + off).sum((-2, -1))
        lo = (masks > t - off).sum((-2, -1))
        stability = torch.where(lo > 0, hi.double() / lo.clamp(min=1).double(),
                                torch.ones_like(hi, dtype=torch.float64))
        keep = (ious > self.pred_iou_thresh) & (stability >= self.stability_score_thresh)
        idx = torch.nonzero(keep).flatten()
        bin_masks = masks[idx] > t
        boxes = mask_to_box(bin_masks).float()
        boxes = torch.where(bin_masks.flatten(1).any(1)[:, None], boxes, torch.zeros_like(boxes))
        return (bin_masks.cpu().numpy(), boxes.cpu().numpy(), ious[idx].cpu().numpy(),
                stability[idx].cpu().numpy(), idx.cpu().numpy())

    def _process_crop(self, image: np.ndarray, crop_box: List[int], layer_idx: int,
                      orig_size: Tuple[int, int]) -> _CropData:
        """`automatic_mask_generator.py:246-295`: encode the crop, sweep its point
        grid, filter, NMS within the crop, uncrop to the original frame."""
        orig_h, orig_w = orig_size
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        self.predictor.set_image(crop)
        grid = self.point_grids[layer_idx] * np.array([cw, ch])
        data = _CropData()
        for start in range(0, len(grid), self.points_per_batch):
            batch = grid[start: start + self.points_per_batch]
            low_multi, ious = self.predictor.predict_point_batch(batch)
            bin_masks, boxes, ious, stability, idx = self._filter_batch(
                low_multi, ious, (ch, cw))
            if not len(idx):
                continue
            pts = batch[idx // low_multi.shape[1]]
            # drop crop-window fragments (a neighbouring crop sees the whole
            # object); image-edge contacts stay
            edge = is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
            for i in np.nonzero(~edge)[0]:
                data.masks.append(uncrop_masks(bin_masks[i], crop_box, orig_h, orig_w))
                data.ious.append(float(ious[i]))
                data.stability.append(float(stability[i]))
                data.points.append(uncrop_points(pts[i], crop_box))
                data.boxes.append(uncrop_boxes_xyxy(boxes[i], crop_box))
                data.crop_boxes.append(list(crop_box))
        if len(data) == 0:
            return data
        keep = np.zeros(len(data), bool)
        keep[nms_boxes(np.stack(data.boxes), np.asarray(data.ious), self.box_nms_thresh)] = True
        data.filter(keep)
        return data

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """`automatic_mask_generator.py:163-243`: the whole image plus (2^i)^2
        overlapping crops per layer i through the grid-prompt pipeline, then
        NMS across crops that prefers masks of smaller crops."""
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(orig_size, self.crop_n_layers,
                                                     self.crop_overlap_ratio)
        data = _CropData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.extend(self._process_crop(image, crop_box, layer_idx, orig_size))
        if len(data) == 0:
            return []
        if len(crop_boxes) > 1:
            scores = 1.0 / np.maximum(box_area(np.stack(
                [np.asarray(cb, np.float32) for cb in data.crop_boxes])), 1e-9)
            keep = np.zeros(len(data), bool)
            keep[nms_boxes(np.stack(data.boxes), scores, self.crop_nms_thresh)] = True
            data.filter(keep)
        results: List[Dict[str, Any]] = []
        for i in range(len(data)):
            mask = data.masks[i]
            if self.min_mask_region_area > 0:
                mask, _ = remove_small_regions(mask, self.min_mask_region_area, "holes")
                mask, _ = remove_small_regions(mask, self.min_mask_region_area, "islands")
            results.append({
                "segmentation": mask if self.output_mode == "binary_mask" else mask_to_rle(mask),
                "area": int(mask.sum()),
                "bbox": box_xyxy_to_xywh(data.boxes[i]).tolist(),
                "predicted_iou": data.ious[i],
                "point_coords": [np.asarray(data.points[i]).tolist()],
                "stability_score": data.stability[i],
                "crop_box": box_xyxy_to_xywh(np.asarray(data.crop_boxes[i], np.float32)).tolist(),
            })
        results.sort(key=lambda r: r["area"], reverse=True)
        return results
