"""TSV shard IO + the SA-1B TSV-sharded segmentation dataset.

Behavioural parity:
- `iggt/datasets/utils/tsv/tsv_io.py:12-93` (`TSVFile`): random access into
  a TSV shard via a `.lineidx` byte-offset sidecar (auto-generated when
  missing, `io_common.py:49-59`), optional split `.label` column file, and
  fork-safe re-opening when the process id changes (DataLoader workers).
- `iggt/datasets/utils/tsv/io_common.py:33-37` (`img_from_base64`): rows
  carry base64-encoded JPEG bytes.
- `iggt/datasets/sa1b_image.py:183-400` (`SA1BDataset`): SA-1B shards named
  `*_<N>.tsv`, subset-selected via SAM_SUBSET_START/END, each row =
  (key, COCO-json annotations, base64 image); per-sample pipeline = random
  flip -> ResizeScale jitter -> FixedSizeCrop to a square -> bitmask
  instances + per-instance point prompts (box of the annotated point +/-3px).

Counterpart of `iggt_official_tpu/data/tsv.py`, copied: pure numpy/PIL (no
detectron2 transform stack, no torch tensors); samples come back
channels-last float32, instance masks a dense (N, H, W) bool stack.
"""

from __future__ import annotations

import base64
import io
import json
import os
import os.path as op
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.data.seg2d import decode_segmentation

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def generate_lineidx(tsv_path: str, idx_path: str) -> None:
    """Write the byte offset of every row (`io_common.py:49-59`)."""
    if os.path.isfile(idx_path):
        raise FileExistsError(idx_path)
    with open(tsv_path, "rb") as fin, open(idx_path, "w", encoding="utf-8") as fout:
        fsize = os.fstat(fin.fileno()).st_size
        fpos = 0
        while fpos != fsize:
            fout.write(f"{fpos}\n")
            fin.readline()
            fpos = fin.tell()


def img_from_base64(image_string: str) -> PIL.Image.Image:
    """base64 JPEG/PNG bytes -> RGB PIL image (`io_common.py:33-37`)."""
    raw = base64.b64decode(image_string)
    return PIL.Image.open(io.BytesIO(raw)).convert("RGB")


def _read_lineidx(path: str) -> List[int]:
    with open(path, encoding="utf-8") as f:
        return [int(line.strip().split()[0]) for line in f if line.strip()]


class TSVFile:
    """Random-access TSV shard with a `.lineidx` sidecar (`tsv_io.py:12`).

    If `<shard>.label` exists, `seek` splices the label file's last column
    between the key and the payload, asserting matching keys
    (`tsv_io.py:44-50`).
    """

    def __init__(self, tsv_file: str):
        self.tsv_file = tsv_file
        self.lineidx = op.splitext(tsv_file)[0] + ".lineidx"
        self.label_file = op.splitext(tsv_file)[0] + ".label"
        self.label_lineidx = op.splitext(tsv_file)[0] + ".label.lineidx"
        self.split_label = os.path.exists(self.label_file)
        self._fp = None
        self._label_fp = None
        self._pid = None
        if not os.path.isfile(self.lineidx) and not os.path.islink(self.lineidx):
            generate_lineidx(self.tsv_file, self.lineidx)
        self._lineidx = _read_lineidx(self.lineidx)
        self._label_lineidx = (
            _read_lineidx(self.label_lineidx) if self.split_label else None
        )

    def num_rows(self) -> int:
        return len(self._lineidx)

    def __len__(self) -> int:
        return self.num_rows()

    def _ensure_opened(self) -> None:
        # re-open after fork so worker processes don't share file offsets
        # (`tsv_io.py:87-93`)
        if self._fp is None or self._pid != os.getpid():
            self._fp = open(self.tsv_file, "r", encoding="utf-8")
            if self.split_label:
                self._label_fp = open(self.label_file, "r", encoding="utf-8")
            self._pid = os.getpid()

    def seek(self, idx: int) -> List[str]:
        self._ensure_opened()
        self._fp.seek(self._lineidx[idx])
        row = [s.strip() for s in self._fp.readline().split("\t")]
        if self.split_label:
            self._label_fp.seek(self._label_lineidx[idx])
            label = [s.strip() for s in self._label_fp.readline().split("\t")]
            assert row[0] == label[0], (row[0], label[0])
            row = [row[0], label[-1], row[-1]]
        return row

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        if self._label_fp is not None:
            self._label_fp.close()
            self._label_fp = None


def _shard_number(name: str) -> Optional[int]:
    stem = op.splitext(name)[0]
    tail = stem.split(".")[0].split("_")[-1]
    return int(tail) if tail.isdigit() else None


def list_tsv_shards(
    root: str, start: int = 0, end: int = 100
) -> List[str]:
    """SA-1B shard selection: `*_<N>.tsv` with start <= N < end
    (`sa1b_image.py:154-157`, SAM_SUBSET_START/END semantics).

    Unnumbered tsv files are included only in a full-range (default)
    listing: partitioned subset workers must not each load the same
    unnumbered shard, but a single-worker run over the whole root should
    still see it."""
    full_range = start <= 0 and end >= 100
    names = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(".tsv"):
            continue
        num = _shard_number(name)
        if num is None:
            if full_range:
                names.append(os.path.join(root, name))
        elif start <= num < end:
            names.append(os.path.join(root, name))
    return names


class SA1BDataset:
    """SA-1B instance-segmentation samples from TSV shards
    (`sa1b_image.py:183-400`).

    Each row: (image key, json with `image` metadata + `annotations`
    [COCO RLE segmentation, bbox XYWH, point_coords], base64 image).
    Augmentation = optional horizontal flip, ResizeScale(min_scale,
    max_scale, image_size), FixedSizeCrop(image_size) — the detectron2
    pipeline re-expressed in numpy.
    """

    def __init__(
        self,
        tsv_root: str,
        image_size: int = 1024,
        min_scale: float = 0.1,
        max_scale: float = 2.0,
        random_flip: str = "horizontal",
        is_train: bool = True,
        subset: Tuple[int, int] = (0, 100),
        seed: Optional[int] = None,
    ):
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.random_flip = random_flip
        self.is_train = is_train
        self.rng = np.random.default_rng(seed)
        self.shards = [TSVFile(p) for p in list_tsv_shards(tsv_root, *subset)]
        self.index: List[Tuple[int, int]] = []
        for tsv_id, shard in enumerate(self.shards):
            n = shard.num_rows() if is_train else min(20, shard.num_rows())
            self.index.extend((tsv_id, i) for i in range(n))

    def __len__(self) -> int:
        return len(self.index)

    def _resize_scale_params(self, h: int, w: int) -> Tuple[int, int]:
        """detectron2 ResizeScale: pick scale in [min,max], resize to fit
        inside (image_size*scale)² preserving aspect."""
        scale = float(self.rng.uniform(self.min_scale, self.max_scale))
        target = self.image_size * scale
        r = min(target / h, target / w)
        return max(1, int(round(h * r))), max(1, int(round(w * r)))

    def __getitem__(self, index: int) -> Dict:
        tsv_id, row_id = self.index[index % max(1, len(self.index))]
        row = self.shards[tsv_id].seek(row_id)
        record = json.loads(row[1])
        if not record.get("annotations"):
            # empty-annotation fallback (`sa1b_image.py:315-320`)
            tsv_id, row_id = 0, 0
            row = self.shards[0].seek(0)
            record = json.loads(row[1])

        image = np.asarray(img_from_base64(row[-1]), np.uint8)
        h, w = image.shape[:2]
        annos = [a for a in record["annotations"] if not a.get("iscrowd", 0)]
        masks = np.stack(
            [decode_segmentation(a["segmentation"], h, w) for a in annos]
        ) if annos else np.zeros((0, h, w), bool)
        points = np.array(
            [a["point_coords"][0] for a in annos], np.float32
        ).reshape(-1, 2)

        # per-instance point prompt as a +/-3px box built in ORIGINAL image
        # coordinates and mapped through the same flip/resize/crop pipeline
        # as gt boxes (`sa1b_image.py:372-373` + detectron2 apply_box), so
        # the box side scales with ResizeScale and flips swap corners
        point_boxes = np.concatenate([points - 3.0, points + 3.0], axis=1)

        flip = (
            self.random_flip == "horizontal"
            and self.is_train
            and bool(self.rng.random() < 0.5)
        )
        if flip:
            image = image[:, ::-1]
            masks = masks[:, :, ::-1]
            # HFlipTransform.apply_box: corners map x -> w - x and swap
            point_boxes = np.stack(
                [
                    w - point_boxes[:, 2],
                    point_boxes[:, 1],
                    w - point_boxes[:, 0],
                    point_boxes[:, 3],
                ],
                axis=1,
            ) if len(point_boxes) else point_boxes

        nh, nw = (
            self._resize_scale_params(h, w)
            if self.is_train
            else (self.image_size, self.image_size)
        )
        pil = PIL.Image.fromarray(image).resize(
            (nw, nh), PIL.Image.Resampling.BILINEAR
        )
        image = np.asarray(pil, np.uint8)
        # center-aligned nearest sampling, matching detectron2's
        # apply_segmentation (PIL NEAREST) instead of top-left alignment
        ys = np.clip(((np.arange(nh) + 0.5) * h / nh).astype(int), 0, h - 1)
        xs = np.clip(((np.arange(nw) + 0.5) * w / nw).astype(int), 0, w - 1)
        masks = masks[:, ys][:, :, xs] if len(masks) else masks.reshape(0, nh, nw)
        point_boxes = point_boxes * np.array(
            [nw / w, nh / h, nw / w, nh / h], np.float32
        )

        # FixedSizeCrop: random crop when larger, zero-pad when smaller;
        # padding_mask marks padded pixels (`sa1b_image.py:334-338`)
        size = self.image_size
        y0 = int(self.rng.integers(0, max(1, nh - size + 1))) if nh > size else 0
        x0 = int(self.rng.integers(0, max(1, nw - size + 1))) if nw > size else 0
        image = image[y0 : y0 + size, x0 : x0 + size]
        masks = masks[:, y0 : y0 + size, x0 : x0 + size]
        point_boxes = point_boxes - np.array([x0, y0, x0, y0], np.float32)
        ch, cw = image.shape[:2]
        out_img = np.zeros((size, size, 3), np.uint8)
        out_img[:ch, :cw] = image
        padding_mask = np.ones((size, size), bool)
        padding_mask[:ch, :cw] = False
        out_masks = np.zeros((len(masks), size, size), bool)
        out_masks[:, :ch, :cw] = masks

        # drop instances emptied by the crop (`filter_empty_instances`)
        keep = out_masks.reshape(len(out_masks), -1).any(-1)
        out_masks = out_masks[keep]
        point_boxes = point_boxes[keep]
        boxes = masks_to_boxes(out_masks)

        img_f = out_img.astype(np.float32) / 255.0
        return {
            "image": img_f,
            "sam_image": (img_f - IMAGENET_MEAN) / IMAGENET_STD,
            "padding_mask": padding_mask,
            "gt_masks": out_masks,
            "gt_boxes": boxes,
            "point_coords": point_boxes,
            "image_id": row[0],
        }


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (N, 4) XYXY tight boxes (empty mask -> zeros)."""
    n = len(masks)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes
