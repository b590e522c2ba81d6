"""First-party instance/semantic/panoptic mask visualizer.

Fills the role of the reference's vendored detectron2 ``Visualizer``
(`utils/visualizer.py:331-1100`: draw_instance_predictions, draw_sem_seg,
draw_panoptic_seg, overlay_instances, draw_binary_mask, draw_box,
draw_text) with a compact numpy/PIL implementation — no matplotlib figure
machinery, output is a plain uint8 RGB array.

Drawing model: masks are alpha-blended with stable per-instance colors,
1-px contours are darkened, and labels are rasterised with PIL at each
mask's centre of mass.

Counterpart of `iggt_official_tpu/utils/visualizer.py`, copied.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_GOLDEN = 0.61803398875


def instance_color(idx: int, s: float = 0.75, v: float = 0.95) -> np.ndarray:
    """Stable distinct RGB color (uint8) for instance ``idx`` via the
    golden-ratio hue walk."""
    h = (idx * _GOLDEN) % 1.0
    i = int(h * 6)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
    ][i % 6]
    return (np.asarray(rgb) * 255).astype(np.uint8)


def _contour(mask: np.ndarray) -> np.ndarray:
    """1-px inner contour of a boolean mask (4-neighbourhood erosion)."""
    m = mask.astype(bool)
    er = m.copy()
    er[1:] &= m[:-1]
    er[:-1] &= m[1:]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def _draw_label(img: np.ndarray, text: str, xy: Tuple[int, int]) -> None:
    try:
        from PIL import Image, ImageDraw
    except ImportError:  # pragma: no cover - PIL is baked in
        return
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    x, y = xy
    # halo for readability
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            draw.text((x + dx, y + dy), text, fill=(0, 0, 0))
    draw.text((x, y), text, fill=(255, 255, 255))
    img[:] = np.asarray(pil)


class Visualizer:
    """Overlay masks/boxes/labels on an RGB image.

    ``img`` is HxWx3, uint8 or float in [0, 1]; every draw method mutates
    the internal canvas and returns it (uint8).
    """

    def __init__(self, img: np.ndarray, alpha: float = 0.55):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        self.img = img.copy()
        self.alpha = float(alpha)

    # ------------------------------------------------------------------
    def draw_binary_mask(
        self,
        mask: np.ndarray,
        color: Optional[np.ndarray] = None,
        label: Optional[str] = None,
        alpha: Optional[float] = None,
    ) -> np.ndarray:
        mask = np.asarray(mask).astype(bool)
        if color is None:
            color = instance_color(int(mask.sum()) % 1024)
        a = self.alpha if alpha is None else alpha
        canvas = self.img.astype(np.float32)
        canvas[mask] = (1 - a) * canvas[mask] + a * np.asarray(
            color, np.float32
        )
        edge = _contour(mask)
        canvas[edge] = np.asarray(color, np.float32) * 0.4
        self.img = canvas.astype(np.uint8)
        if label and mask.any():
            ys, xs = np.nonzero(mask)
            _draw_label(
                self.img, label, (int(xs.mean()), int(ys.mean()))
            )
        return self.img

    def draw_box(
        self, box: Sequence[float], color=(0, 255, 0)
    ) -> np.ndarray:
        """box = (x0, y0, x1, y1)."""
        x0, y0, x1, y1 = [int(round(c)) for c in box]
        H, W = self.img.shape[:2]
        x0, x1 = np.clip([x0, x1], 0, W - 1)
        y0, y1 = np.clip([y0, y1], 0, H - 1)
        c = np.asarray(color, np.uint8)
        self.img[y0, x0:x1 + 1] = c
        self.img[y1, x0:x1 + 1] = c
        self.img[y0:y1 + 1, x0] = c
        self.img[y0:y1 + 1, x1] = c
        return self.img

    # ------------------------------------------------------------------
    def draw_instances(
        self,
        masks: np.ndarray,                  # (N, H, W) bool
        labels: Optional[List[str]] = None,
        scores: Optional[Sequence[float]] = None,
        boxes: Optional[np.ndarray] = None,  # (N, 4)
    ) -> np.ndarray:
        """detectron2 ``draw_instance_predictions`` equivalent."""
        masks = np.asarray(masks)
        order = np.argsort([-m.sum() for m in masks])  # big first, on bottom
        for rank, i in enumerate(order):
            text = None
            if labels is not None:
                text = labels[i]
                if scores is not None:
                    text = f"{text} {scores[i]:.0%}"
            elif scores is not None:
                text = f"{scores[i]:.0%}"
            self.draw_binary_mask(
                masks[i], instance_color(int(i)), label=text
            )
        if boxes is not None:
            for i in order:
                self.draw_box(boxes[i], instance_color(int(i)))
        return self.img

    def draw_sem_seg(
        self,
        sem_seg: np.ndarray,                # (H, W) int class ids
        class_names: Optional[Sequence[str]] = None,
        ignore_label: int = 255,
    ) -> np.ndarray:
        for cid in np.unique(sem_seg):
            if cid == ignore_label:
                continue
            name = (
                class_names[cid]
                if class_names is not None and cid < len(class_names)
                else None
            )
            self.draw_binary_mask(
                sem_seg == cid, instance_color(int(cid)), label=name
            )
        return self.img

    def draw_panoptic_seg(
        self,
        panoptic_seg: np.ndarray,           # (H, W) segment ids
        segments_info: List[Dict],          # [{"id", "category_name"?}]
    ) -> np.ndarray:
        for seg in segments_info:
            self.draw_binary_mask(
                panoptic_seg == seg["id"],
                instance_color(int(seg["id"])),
                label=seg.get("category_name"),
            )
        return self.img

    def get_image(self) -> np.ndarray:
        return self.img
