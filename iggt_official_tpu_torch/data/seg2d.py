"""2D segmentation datasets: COCO-format entity masks + SAV masklets.

Behavioural parity:
- `iggt/datasets/entity_image.py:29-62` (`EntityImage`): COCO-style JSON
  annotations (polygons or RLE) over an image folder, random resize-or-crop
  to a square resolution, retrying bad samples.
- `iggt/datasets/sav.py:51-190` (`SAVDataset`): reads SAM2 `auto_masks.json`
  masklet annotations and samples decoded masks per frame.

Counterpart of `iggt_official_tpu/data/seg2d.py`, copied.  Both use the
port's COCO RLE codec (`data/rle.py`) in place of pycocotools.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.data import rle as rle_codec


def _polygon_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation via PIL."""
    from PIL import ImageDraw

    img = PIL.Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, bool)


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygon list | RLE dict) -> bool mask."""
    if isinstance(seg, dict):
        return rle_codec.decode(seg) > 0
    return _polygon_to_mask(seg, h, w)


class EntityImage:
    """COCO-format instance dataset (`entity_image.py:29-62`)."""

    def __init__(
        self,
        image_root: str,
        annotation_json: str,
        resolution: int = 512,
        seed: Optional[int] = None,
    ):
        self.image_root = image_root
        self.resolution = resolution
        self.rng = np.random.default_rng(seed)
        with open(annotation_json, encoding="utf-8") as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image: Dict[int, List[Dict]] = {}
        for ann in coco.get("annotations", []):
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict:
        image_id = self.ids[idx % len(self.ids)]
        info = self.images[image_id]
        path = os.path.join(self.image_root, info["file_name"])
        image = PIL.Image.open(path).convert("RGB")
        w, h = image.size

        instance_ids = np.zeros((h, w), np.int32)
        for i, ann in enumerate(self.anns_by_image.get(image_id, [])):
            mask = decode_segmentation(ann["segmentation"], h, w)
            instance_ids[mask] = i + 1

        # random square resize-or-crop (`entity_image.py:38-58`)
        res = self.resolution
        if min(h, w) > res and self.rng.random() < 0.5:
            y0 = int(self.rng.integers(0, h - res + 1))
            x0 = int(self.rng.integers(0, w - res + 1))
            image = image.crop((x0, y0, x0 + res, y0 + res))
            instance_ids = instance_ids[y0 : y0 + res, x0 : x0 + res]
        else:
            image = image.resize((res, res), PIL.Image.Resampling.BILINEAR)
            ys = np.linspace(0, h - 1, res).astype(int)
            xs = np.linspace(0, w - 1, res).astype(int)
            instance_ids = instance_ids[ys][:, xs]

        return {
            "img": np.asarray(image, np.float32) / 255.0,
            "instance_ids": instance_ids,
            "image_id": image_id,
        }


class SAVDataset:
    """SAM2 masklet annotation reader (`sav.py:44-190`)."""

    def __init__(self, sav_dir: Optional[str] = None, annot_sample_rate: int = 4):
        self.sav_dir = sav_dir
        self.annot_sample_rate = annot_sample_rate

    def load_annotation_from_json(self, json_path: str) -> Dict:
        if not os.path.exists(json_path):
            raise FileNotFoundError(json_path)
        with open(json_path, encoding="utf-8") as f:
            return json.load(f)

    def sample_masks_from_frames(
        self,
        json_path: str,
        frame_ids: Union[List[int], int],
        mask_sample_num: Optional[int] = None,
        random_seed: Optional[int] = None,
    ) -> Dict[int, List[np.ndarray]]:
        """frame id -> list of decoded bool masks (`sav.py:70-119`)."""
        data = self.load_annotation_from_json(json_path)
        masklet = data.get("masklet", [])
        if isinstance(frame_ids, int):
            frame_ids = [frame_ids]
        rng = np.random.default_rng(random_seed)
        out: Dict[int, List[np.ndarray]] = {}
        for frame_id in frame_ids:
            if not 0 <= frame_id < len(masklet):
                continue
            frame_masks = masklet[frame_id]
            if not frame_masks:
                out[frame_id] = []
                continue
            indices = np.arange(len(frame_masks))
            if mask_sample_num is not None and mask_sample_num < len(indices):
                indices = rng.choice(indices, mask_sample_num, replace=False)
            out[frame_id] = [
                rle_codec.decode(frame_masks[i]) > 0 for i in indices
            ]
        return out
