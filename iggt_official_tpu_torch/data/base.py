"""Multi-view dataset base contract.

Counterpart of `iggt_official_tpu/data/base.py`, copied (numpy and PIL):
``dataset[(idx, ar_idx, num)]`` returns ``num`` views -- the anchor plus
covisible frames -- each a dict of img / depthmap / camera_pose (c2w) /
camera_intrinsics / pts3d / valid_mask / true_shape / metadata;
principal-point-centered cropping and Lanczos rescale adjust the
intrinsics; portrait views are transposed to landscape.  ``img`` is HWC
float32 in [0, 1] (channels-last, the model's layout).  ``aug_focal`` draws
from numpy's global RNG (``np.random.beta``), as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.data import cropping
from iggt_official_tpu_torch.data.easy_dataset import EasyDataset


def img_to_array(image: PIL.Image.Image) -> np.ndarray:
    """ImgNorm equivalent (`datasets/utils/transforms.py:11`): ToTensor ->
    float [0, 1]; channels-last here."""
    return np.asarray(image, np.float32) / 255.0


def depthmap_to_camera_coordinates(
    depthmap: np.ndarray, camera_intrinsics: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-grid unprojection (`iggt/utils/geometry.py:238-268` numpy)."""
    H, W = depthmap.shape
    fu, fv = camera_intrinsics[0, 0], camera_intrinsics[1, 1]
    cu, cv = camera_intrinsics[0, 2], camera_intrinsics[1, 2]
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    z = depthmap
    x = (u - cu) * z / fu
    y = (v - cv) * z / fv
    X_cam = np.stack([x, y, z], axis=-1).astype(np.float32)
    valid = depthmap > 0.0
    return X_cam, valid


def depthmap_to_absolute_camera_coordinates(
    depthmap: np.ndarray,
    camera_intrinsics: np.ndarray,
    camera_pose: Optional[np.ndarray],
    z_far: float = 0,
    **_,
) -> Tuple[np.ndarray, np.ndarray]:
    """Depth -> world points + valid mask (`geometry.py:126-148`)."""
    X_cam, valid = depthmap_to_camera_coordinates(depthmap, camera_intrinsics)
    if z_far > 0:
        valid = valid & (depthmap < z_far)
    X_world = X_cam
    if camera_pose is not None and np.isfinite(camera_pose).all():
        R = camera_pose[:3, :3]
        t = camera_pose[:3, 3]
        X_world = np.einsum("ik,vuk->vui", R, X_cam) + t[None, None, :]
    return X_world.astype(np.float32), valid


def transpose_to_landscape(view: Dict) -> None:
    """Portrait -> landscape in place (`base_stereo_view_dataset.py:214-233`),
    HWC layout."""
    height, width = view["true_shape"]
    if width < height:
        view["img"] = view["img"].swapaxes(0, 1)
        view["valid_mask"] = view["valid_mask"].swapaxes(0, 1)
        view["depthmap"] = view["depthmap"].swapaxes(0, 1)
        view["pts3d"] = view["pts3d"].swapaxes(0, 1)
        view["camera_intrinsics"] = view["camera_intrinsics"][[1, 0, 2]]
        view["true_shape"] = np.int32((width, height))


class BaseViewDataset(EasyDataset):
    """Subclasses implement `_get_views(idx, num, resolution, rng)`."""

    def __init__(
        self,
        *,
        split: Optional[str] = None,
        resolution=None,
        aug_crop: int = 0,
        aug_focal: float = 0.0,
        z_far: float = 0,
        seed: Optional[int] = None,
    ):
        self.split = split
        self._set_resolutions(resolution)
        self.aug_crop = aug_crop
        self.aug_focal = aug_focal
        self.z_far = z_far
        self.seed = seed

    # -- contract -----------------------------------------------------
    def _get_views(self, idx: int, num: int, resolution, rng) -> List[Dict]:
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    # -- indexing (`scannet.py:250-285`) ------------------------------
    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            if len(idx) == 2:
                idx, ar_idx = idx
                num = 1
            elif len(idx) == 3:
                idx, ar_idx, num = idx
            else:
                # sampler group with several anchors: (a1..aL, ar, batch) —
                # the reference handles this only through its wrapper
                # datasets; accept it directly and flatten
                *anchors, ar_idx, batch_size = idx
                per = batch_size // len(anchors)
                out = []
                for a in anchors:
                    out.extend(self[(a, ar_idx, per)])
                return out
        else:
            assert len(self._resolutions) == 1
            ar_idx, num = 0, 1

        if self.seed:
            self._rng = np.random.default_rng(seed=self.seed + idx)
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()

        resolution = self._resolutions[ar_idx]
        views = self._get_views(idx, num, resolution, self._rng)
        assert len(views) == num

        for v, view in enumerate(views):
            assert "pts3d" not in view and "valid_mask" not in view
            view["idx"] = (idx, ar_idx, v)

            img = view["img"]
            if isinstance(img, PIL.Image.Image):
                width, height = img.size
                view["img"] = img_to_array(img)
            else:
                height, width = img.shape[:2]
            view["true_shape"] = np.int32((height, width))

            assert "camera_intrinsics" in view
            if "camera_pose" not in view:
                view["camera_pose"] = np.full((4, 4), np.nan, np.float32)
            else:
                assert np.isfinite(view["camera_pose"]).all()
            assert np.isfinite(view["depthmap"]).all()
            view["z_far"] = self.z_far
            pts3d, valid = depthmap_to_absolute_camera_coordinates(**view)
            view["pts3d"] = pts3d
            view["valid_mask"] = valid & np.isfinite(pts3d).all(axis=-1)

        for view in views:
            transpose_to_landscape(view)
            view["rng"] = int.from_bytes(self._rng.bytes(4), "big")
        return views

    # -- helpers ------------------------------------------------------
    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        self._resolutions = []
        for r in resolutions:
            w, h = (r, r) if isinstance(r, int) else r
            assert isinstance(w, int) and isinstance(h, int)
            assert w >= h
            self._resolutions.append((w, h))

    def _crop_resize_if_necessary(
        self, image, depthmap, intrinsics, resolution, rng=None, info=None
    ):
        """Principal-point-centered crop + Lanczos rescale + final crop
        (`base_stereo_view_dataset.py:142-193`)."""
        if not isinstance(image, PIL.Image.Image):
            image = PIL.Image.fromarray(image)

        W, H = image.size
        cx, cy = np.round(intrinsics[:2, 2]).astype(int)
        min_margin_x = min(cx, W - cx)
        min_margin_y = min(cy, H - cy)
        assert min_margin_x > W / 5, f"Bad principal point in view={info}"
        assert min_margin_y > H / 5, f"Bad principal point in view={info}"
        l, t = cx - min_margin_x, cy - min_margin_y
        r, b = cx + min_margin_x, cy + min_margin_y
        image, depthmap, intrinsics, _ = cropping.crop_image_depthmap(
            image, depthmap, intrinsics, (l, t, r, b)
        )

        target_resolution = np.array(resolution)
        if self.aug_focal:
            crop_scale = self.aug_focal + (1.0 - self.aug_focal) * float(
                np.random.beta(0.5, 0.5)
            )
            image, depthmap, intrinsics = cropping.center_crop_image_depthmap(
                image, depthmap, intrinsics, crop_scale
            )
        if self.aug_crop > 1:
            target_resolution = target_resolution + rng.integers(0, self.aug_crop)
        image, depthmap, intrinsics = cropping.rescale_image_depthmap(
            image, depthmap, intrinsics, target_resolution
        )

        intrinsics2 = cropping.camera_matrix_of_crop(
            intrinsics, image.size, resolution, offset_factor=0.5
        )
        crop_bbox = cropping.bbox_from_intrinsics_in_out(
            intrinsics, intrinsics2, resolution
        )
        image, depthmap, intrinsics2, _ = cropping.crop_image_depthmap(
            image, depthmap, intrinsics, crop_bbox
        )
        return image, depthmap, intrinsics2


def threshold_depth_map(
    depth_map: np.ndarray,
    max_percentile: float = 99,
    min_percentile: float = 1,
    max_depth: float = -1,
) -> np.ndarray:
    """Percentile thresholding (`datasets/utils/misc.py:488-541`)."""
    if max_depth > 0:
        depth_map[depth_map > max_depth] = 0.0
    if max_percentile > 0:
        hi = np.nanpercentile(depth_map, max_percentile)
        if hi > 0:
            depth_map[depth_map > hi] = 0.0
    if min_percentile > 0:
        lo = np.nanpercentile(depth_map, min_percentile)
        if lo > 0:
            depth_map[depth_map < lo] = 0.0
    return depth_map
