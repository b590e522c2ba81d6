"""Track visualization: per-frame overlays of points coloured by position.

Counterpart of `iggt_official_tpu/utils/visual_track.py`
(`visualize_tracks_on_images`): each track takes the colour of its (x, y)
position in its first visible frame under a colormap (``hsv``), is drawn as
a filled disc on every frame where it is visible, and the frames are saved
as PNGs and, optionally, as one grid image.  numpy and PIL only, with the
port's own colormap tables (the card machine has neither cv2 nor
matplotlib).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from iggt_official_tpu_torch.utils.colormaps import get_cmap


def color_from_xy(x: float, y: float, W: int, H: int,
                  cmap_name: str = "hsv") -> Tuple[float, float, float]:
    """(x, y) -> RGB in [0, 1]: the colormap at the mean of x / (W - 1) and
    y / (H - 1), clipped to [0, 1]."""
    c = (x / max(W - 1, 1) + y / max(H - 1, 1)) / 2.0
    r, g, b = get_cmap(cmap_name)(np.array([float(np.clip(c, 0, 1))]))[0]
    return (float(r), float(g), float(b))


def get_track_colors_by_position(tracks: np.ndarray, vis_mask: Optional[np.ndarray] = None,
                                 image_width: int = None, image_height: int = None,
                                 cmap_name: str = "hsv") -> np.ndarray:
    """(S, N, 2) tracks -> (N, 3) uint8 colours; a track never visible stays
    black."""
    S, N, _ = tracks.shape
    if vis_mask is None:
        vis_mask = np.ones((S, N), bool)
    colors = np.zeros((N, 3), np.uint8)
    for i in range(N):
        visible = np.flatnonzero(vis_mask[:, i])
        if len(visible) == 0:
            continue
        x, y = tracks[visible[0], i]
        r, g, b = color_from_xy(x, y, image_width, image_height, cmap_name)
        colors[i] = (int(r * 255), int(g * 255), int(b * 255))
    return colors


def _draw_point(img: np.ndarray, x: float, y: float, color, radius: int = 3) -> None:
    """A filled disc of ``radius`` around the rounded (x, y), clipped to the image."""
    H, W = img.shape[:2]
    cx, cy = int(round(x)), int(round(y))
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, H)
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, W)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][(yy - cy) ** 2 + (xx - cx) ** 2 <= radius ** 2] = color


def visualize_tracks_on_images(images: np.ndarray, tracks: np.ndarray,
                               track_vis_mask: Optional[np.ndarray] = None,
                               out_dir: str = "track_visuals", cmap_name: str = "hsv",
                               frames_per_row: int = 4, save_grid: bool = True,
                               radius: int = 3) -> np.ndarray:
    """images (S, H, W, 3) in [0, 1] and tracks (S, N, 2) pixel xy (a leading
    batch of 1 is dropped).  Writes ``frame_XXXX.png`` (and
    ``tracks_grid.png``) under ``out_dir``; returns the frames (S, H, W, 3)
    uint8."""
    from PIL import Image

    if tracks.ndim == 4:
        tracks, images = tracks[0], images[0]
        if track_vis_mask is not None and track_vis_mask.ndim == 3:
            track_vis_mask = track_vis_mask[0]
    S, H, W, _ = images.shape
    colors = get_track_colors_by_position(tracks, track_vis_mask, W, H, cmap_name)
    os.makedirs(out_dir, exist_ok=True)
    frames = (np.clip(images, 0, 1) * 255).astype(np.uint8).copy()
    for s in range(S):
        for i in range(tracks.shape[1]):
            if track_vis_mask is not None and not track_vis_mask[s, i]:
                continue
            x, y = tracks[s, i]
            _draw_point(frames[s], x, y, colors[i], radius)
        Image.fromarray(frames[s]).save(os.path.join(out_dir, f"frame_{s:04d}.png"))
    if save_grid:
        rows = -(-S // frames_per_row)
        grid = np.zeros((rows * H, frames_per_row * W, 3), np.uint8)
        for s in range(S):
            r, c = divmod(s, frames_per_row)
            grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = frames[s]
        Image.fromarray(grid).save(os.path.join(out_dir, "tracks_grid.png"))
    return frames
