"""Named dataset registry.

Counterpart of `iggt_official_tpu/data/datasets.py`, copied: every class of
its registry `DATASETS` with the same knob values, `MaskletMixin` included.
The cv2 reads become `data/imread.py`'s PIL decoders, byte-equal to cv2's
(Kubric's 16-bit depth PNG, ``IMREAD_UNCHANGED``; MapFree's sky-mask JPEG,
``IMREAD_GRAYSCALE``; Vkitti's depth PNG, ``IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH``); the EXR-depth loaders (MegaDepth, MvsSynth, Waymo,
Habitat, Replica) raise an ImportError that names cv2 when they read a
frame.  The reference ships ~30 per-dataset loader files that all follow the
SceneDirDataset pattern, differing in directory layout, file extensions,
depth encodings, camera containers and pose conventions (see each class's
note); `DATASETS` is the name -> class registry that `get_data_loader`'s
expression strings are evaluated against.  The masklet pseudo-GT path
attaches per-view ``instance_ids`` decoded with the first-party COCO RLE
codec (`data/rle.py`).
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Dict, Type

import numpy as np

from iggt_official_tpu_torch.data import rle as rle_codec
from iggt_official_tpu_torch.data.imread import imread_anydepth, imread_grayscale, imread_unchanged
from iggt_official_tpu_torch.data.scene_dataset import SceneDirDataset


class Scannet(SceneDirDataset):
    """`iggt/datasets/scannet.py:107-137`: color/*.jpg, depth/*.png
    (mm uint16 / 1000), cam/*.npz `pose`/`intrinsics`, z_far 100."""

    dataset_label = "Scannet"


class MaskletMixin:
    """SAM2 masklet pseudo-GT: per-sequence ``auto_masks.json`` with COCO
    RLE masks, attached as per-view ``instance_ids``
    (`dl3dv.py:241-451`, `re10k.py:122-148`, `sav.py:51-190`)."""

    def __init__(self, *args, load_masklets: bool = True, **kwargs):
        self.load_masklets = load_masklets
        self._masklets: Dict[str, list] = {}
        super().__init__(*args, **kwargs)

    def _seq_and_frame(self, global_idx: int):
        """Sequence dir + within-sequence frame number for a global index."""
        rgb_path = self.all_rgb_paths[global_idx]
        seq_dir = rgb_path
        for _ in range(1 + len(self.color_dir.split(os.sep))):
            seq_dir = os.path.dirname(seq_dir)
        # frames of one sequence are contiguous and sorted; match the
        # directory boundary (seq_dir + sep), not a raw string prefix —
        # sibling dirs like ``scene_1-old`` sort before ``scene_1/`` and
        # would otherwise be counted into this sequence
        prefix = seq_dir + os.sep
        base = global_idx
        while base > 0 and self.all_rgb_paths[base - 1].startswith(prefix):
            base -= 1
        return seq_dir, global_idx - base

    def _get_views(self, index, num, resolution, rng):
        views = super()._get_views(index, num, resolution, rng)
        if not self.load_masklets:
            return views
        for view in views:
            seq_dir, frame_no = self._seq_and_frame(view["frame_index"])
            mask_json = os.path.join(seq_dir, "auto_masks.json")
            if not os.path.exists(mask_json):
                continue
            if mask_json not in self._masklets:
                with open(mask_json, encoding="utf-8") as f:
                    self._masklets[mask_json] = json.load(f)["masklet"]
            masklets = self._masklets[mask_json]
            if frame_no < len(masklets):
                m = rle_codec.decode(masklets[frame_no])
                H, W = view["depthmap"].shape
                if m.shape != (H, W):
                    ys = (np.linspace(0, m.shape[0] - 1, H)).astype(int)
                    xs = (np.linspace(0, m.shape[1] - 1, W)).astype(int)
                    m = m[ys][:, xs]
                view["instance_ids"] = m.astype(np.int32)
        return views


class Scannetpp(SceneDirDataset):
    """`iggt/datasets/scannetpp.py:67-250`: per-sequence metadata npz
    (stacked trajectories/intrinsics; DSLR `DSC*` frames skipped so only
    iPhone frames index) + instance-id maps via the images -> obj_ids
    path rewrite."""

    dataset_label = "Scannetpp"
    color_dir = "images"
    color_ext = "frame_*.jpg"
    depth_ext = "frame_*.png"
    metadata_name = "new_scene_metadata.npz"
    load_obj_ids = True

    def _scan_sequence(self, seq):
        rgb_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_dir, self.color_ext))
        )
        depth_paths = sorted(
            _glob.glob(os.path.join(seq, "depth", self.depth_ext))
        )
        meta_path = os.path.join(seq, self.metadata_name)
        if not rgb_paths or not os.path.exists(meta_path):
            return None
        meta = np.load(meta_path, allow_pickle=True)
        image_list = [str(s) for s in meta["images"]]
        dsc_count = len([s for s in image_list if s.startswith("DSC")])
        cams = []
        for pose, K in zip(
            meta["trajectories"][dsc_count:], meta["intrinsics"][dsc_count:]
        ):
            pose = np.asarray(pose, np.float32)
            K = np.asarray(K, np.float32)
            assert pose.shape == (4, 4) and K.shape == (3, 3), meta_path
            cams.append((pose, K))
        return rgb_paths, depth_paths, cams, None

    def _get_views(self, index, num, resolution, rng):
        views = super()._get_views(index, num, resolution, rng)
        if not self.load_obj_ids:
            return views
        for view in views:
            rgb = self.all_rgb_paths[view["frame_index"]]
            obj_path = rgb.replace(
                f"{os.sep}images{os.sep}", f"{os.sep}obj_ids{os.sep}"
            ) + ".pth"
            if not os.path.exists(obj_path):
                continue
            import torch

            ids = torch.load(obj_path, map_location="cpu",
                             weights_only=False)
            ids = np.asarray(ids, np.int32)
            H, W = view["depthmap"].shape
            if ids.shape != (H, W):
                ys = (np.linspace(0, ids.shape[0] - 1, H)).astype(int)
                xs = (np.linspace(0, ids.shape[1] - 1, W)).astype(int)
                ids = ids[ys][:, xs]
            view["instance_ids"] = ids
        return views


class ScannetppV2(Scannetpp):
    """`iggt/datasets/scannetpp.py` scannetppv2 variant: iPhone metadata
    file (`scannetpp.py:137-140`)."""

    dataset_label = "scannetppv2"
    metadata_name = "scene_iphone_metadata.npz"


class Re10K(MaskletMixin, SceneDirDataset):
    """`iggt/datasets/re10k.py` (COLMAP-derived; see data/colmap.py for the
    model readers used during preprocessing).  Binds the masklet pseudo-GT
    path (`re10k.py:122-148`)."""

    dataset_label = "Re10K"
    min_frames = 2


class _MetadataNpzDataset(SceneDirDataset):
    """ARKitScenes-style per-sequence metadata npz: frame names come from
    the npz `images` list (rgb renamed .png -> .jpg under `vga_wide/`),
    poses/intrinsics are stacked arrays (`arkitscenes.py:113-135`)."""

    color_dir = "vga_wide"
    metadata_name = "new_scene_metadata.npz"

    def _scan_sequence(self, seq):
        meta_path = os.path.join(seq, self.metadata_name)
        if not os.path.exists(meta_path):
            return None
        meta = np.load(meta_path, allow_pickle=True)
        names = [str(s) for s in meta["images"]]
        rgb_paths = [
            os.path.join(seq, self.color_dir, n.replace(".png", ".jpg"))
            for n in names
        ]
        depth_paths = [os.path.join(seq, self.depth_dir, n) for n in names]
        cams = []
        for pose, K in zip(meta["trajectories"], meta["intrinsics"]):
            cams.append(
                (np.asarray(pose, np.float32), np.asarray(K, np.float32))
            )
        return rgb_paths, depth_paths, cams, None


class ARKitScenes(_MetadataNpzDataset):
    """`iggt/datasets/arkitscenes.py:108-135`: vga_wide rgb (npz names,
    .png->.jpg), lowres_depth mm/1000, new_scene_metadata.npz, z_far 20."""

    dataset_label = "ARKitScenes"
    depth_dir = "lowres_depth"
    z_far_default = 20.0


class ARKitScenesHigh(_MetadataNpzDataset):
    """`iggt/datasets/arkitscenes_high.py`: highres_depth +
    scene_metadata.npz variant, z_far 20."""

    dataset_label = "ARKitScenesHigh"
    depth_dir = "highres_depth"
    metadata_name = "scene_metadata.npz"
    z_far_default = 20.0


class Bedlam(SceneDirDataset):
    """`iggt/datasets/bedlam.py:110-137`: rgb/*.png, depth/*.npy,
    cam/*.npz `pose`/`intrinsics`, z_far 200."""

    dataset_label = "Bedlam"
    color_dir = "rgb"
    color_ext = "*.png"
    depth_mode = "npy"
    depth_ext = "*.npy"
    z_far_default = 200.0


class BlendedMVS(SceneDirDataset):
    """`iggt/datasets/blendedmvs.py`: PFM depth, split R/t camera keys."""

    dataset_label = "BlendedMVS"
    depth_mode = "pfm"
    depth_ext = "*.pfm"


class Carla(SceneDirDataset):
    """`iggt/datasets/carla.py:160-195`: per-scene `params/` json cameras
    shared across `<time_index>/{rgb,depth}/camera_*.png` captures; depth
    PNG is uint16 at 65535/1000 m (`carla.py:66-67`); the json extrinsic is
    UE-convention and flipped via diag(1,-1,-1) (`carla.py:55-63`)."""

    dataset_label = "Carla"
    depth_mode = "png_maxdepth"
    max_depth = 1000.0
    z_far_default = 1000.0
    min_frames = 2  # the reference carla loader has no 24-frame skip

    def _scan_sequence(self, seq):
        params_dir = os.path.join(seq, "params")
        if not os.path.isdir(params_dir):
            return None
        cams = []
        for p in sorted(os.listdir(params_dir)):
            with open(os.path.join(params_dir, p), encoding="utf-8") as f:
                d = json.load(f)
            K = np.asarray(d["intrinsic"], np.float32)
            c2w = np.asarray(d["extrinsic"], np.float32)
            rot = np.eye(4, dtype=np.float32)
            rot[1, 1] = rot[2, 2] = -1
            cams.append((rot @ c2w, K))
        rgb_paths, depth_paths, all_cams = [], [], []
        times = sorted(
            t for t in os.listdir(seq)
            if os.path.isdir(os.path.join(seq, t)) and t != "params"
        )
        for t in times:
            rgbs = sorted(
                _glob.glob(os.path.join(seq, t, "rgb", "camera_*.png"))
            )
            deps = sorted(
                _glob.glob(os.path.join(seq, t, "depth", "camera_*.png"))
            )
            if len(rgbs) != len(cams) or len(deps) != len(cams):
                continue
            rgb_paths.extend(rgbs)
            depth_paths.extend(deps)
            all_cams.extend(cams)
        if not rgb_paths:
            return None
        return rgb_paths, depth_paths, all_cams, None


class Co3d(SceneDirDataset):
    """`iggt/datasets/co3d.py:107-179`: category/sequence nesting,
    `camera_pose` npz key, per-frame `maximum_depth` scaling the uint16
    depth PNGs (raw / 65535 * max_depth)."""

    dataset_label = "Co3d"
    color_dir = "images"
    min_frames = 2
    seq_depth = 2
    pose_key = "camera_pose"
    depth_mode = "png_maxdepth"
    max_depth_key = "maximum_depth"


class Cop3d(Co3d):
    """`iggt/datasets/cop3d.py` (co3d layout)."""

    dataset_label = "Cop3d"


class DynamicReplica(SceneDirDataset):
    """`iggt/datasets/dynamic_replica.py:109-136`: <seq>/<sub>/rgb|depth|
    cam nesting (depth npy), z_far 100."""

    dataset_label = "Dynamic_Replica"
    color_dir = "rgb"
    color_ext = "*.png"
    depth_mode = "npy"
    depth_ext = "*.npy"
    seq_depth = 2


class _JsonCamDataset(SceneDirDataset):
    """Habitat/Replica layout (`habitat.py:100-131`, `replica.py:105-120`):
    rgb `*.jpeg`, depth `*.exr` and per-frame `*.json` cameras
    (`camera_intrinsics` + `R_cam2world`/`t_cam2world`) all in one dir."""

    color_dir = ""
    depth_dir = ""
    color_ext = "*.jpeg"
    depth_ext = "*.exr"
    depth_mode = "exr"
    cam_glob = "*.json"
    z_far_default = 80.0

    def _frame_dir(self, seq: str) -> str:
        return seq

    def _scan_sequence(self, seq):
        d = self._frame_dir(seq)
        rgb_paths = sorted(_glob.glob(os.path.join(d, self.color_ext)))
        depth_paths = sorted(_glob.glob(os.path.join(d, self.depth_ext)))
        cam_paths = sorted(_glob.glob(os.path.join(d, self.cam_glob)))
        if not rgb_paths or len(cam_paths) != len(rgb_paths):
            return None
        cams = []
        for p in cam_paths:
            with open(p, encoding="utf-8") as f:
                cp = json.load(f)
            K = np.float32(cp["camera_intrinsics"])
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = cp["R_cam2world"]
            pose[:3, 3] = cp["t_cam2world"]
            cams.append((pose, K))
        return rgb_paths, depth_paths, cams, None


class Habitat(_JsonCamDataset):
    """`iggt/datasets/habitat.py:99-113`: frames live under the
    `<hash>.basis/` subdir derived from the sequence name."""

    dataset_label = "Habitat"

    def _frame_dir(self, seq):
        name = os.path.basename(os.path.normpath(seq))
        return os.path.join(seq, name.split("-")[-1] + ".basis")


class Replica(_JsonCamDataset):
    """`iggt/datasets/replica.py:105-120`, z_far 80 (`replica.py:388`)."""

    dataset_label = "Replica"


class Hypersim(SceneDirDataset):
    """`iggt/datasets/hypersim.py:128-176`: flat <scene>/<sub>/ dirs with
    rgb *.png + depth *.npy + cam *.npz, the `broken_scenes` skip list
    (`hypersim.py:25-45`), min 24 frames, z_far 200."""

    dataset_label = "Hypersim"
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    color_ext = "*.png"
    depth_ext = "*.npy"
    depth_mode = "npy"
    seq_depth = 2
    z_far_default = 200.0
    skip_scenes = frozenset([
        "ai_003_001", "ai_004_009", "ai_015_006", "ai_038_007", "ai_046_001",
        "ai_046_009", "ai_048_004", "ai_053_005", "ai_012_007", "ai_013_001",
        "ai_023_008", "ai_026_020", "ai_023_009", "ai_023_004", "ai_023_006",
        "ai_026_013", "ai_026_018",
    ])


class Infinigen(SceneDirDataset):
    """`iggt/datasets/infinigen.py:127-175`: scene*/<sub>/frames/ tree with
    Image/camera_0/Image_*.png, Depth/camera_0/Depth_*.npy, camview npz
    (`T`/`K` keys) and ObjectSegmentation_*.npy instance maps attached as
    ``instance_ids`` (`infinigen.py:381-414`)."""

    dataset_label = "Infinigen"
    color_dir = os.path.join("frames", "Image", "camera_0")
    depth_dir = os.path.join("frames", "Depth", "camera_0")
    cam_dir = os.path.join("frames", "camview", "camera_0")
    color_ext = "Image_*.png"
    depth_ext = "Depth_*.npy"
    cam_ext = "camview_*.npz"
    depth_mode = "npy"
    pose_keys = ("T",)
    intr_keys = ("K",)
    seq_depth = 2
    seq_glob = os.path.join("scene*", "*")
    load_seg = True
    aux_list_names = ("all_seg_paths",)

    def __init__(self, *args, **kwargs):
        self.all_seg_paths = []
        super().__init__(*args, **kwargs)

    def _scan_sequence(self, seq):
        scanned = super()._scan_sequence(seq)
        # the min_frames check must happen before the aux list extends, or
        # a base-class skip would desync all_seg_paths from the index
        if scanned is None or len(scanned[0]) < self.min_frames:
            return None
        seg = sorted(_glob.glob(os.path.join(
            seq, "frames", "ObjectSegmentation", "camera_0",
            "ObjectSegmentation_*.npy")))
        n = len(scanned[0])
        self.all_seg_paths.extend(seg if len(seg) == n else [None] * n)
        return scanned

    def _get_views(self, index, num, resolution, rng):
        views = super()._get_views(index, num, resolution, rng)
        if not self.load_seg:
            return views
        for view in views:
            seg_path = self.all_seg_paths[view["frame_index"]]
            if seg_path is None or not os.path.exists(seg_path):
                continue
            ids = np.load(seg_path).astype(np.int64)
            if ids.ndim == 3:
                ids = ids[..., 0]
            H, W = view["depthmap"].shape
            if ids.shape != (H, W):
                ys = (np.linspace(0, ids.shape[0] - 1, H)).astype(int)
                xs = (np.linspace(0, ids.shape[1] - 1, W)).astype(int)
                ids = ids[ys][:, xs]
            # compact ids to a small int range (raw infinigen ids are
            # large object hashes)
            _, ids = np.unique(ids, return_inverse=True)
            view["instance_ids"] = ids.reshape(H, W).astype(np.int32)
        return views


class Kubric(SceneDirDataset):
    """`iggt/datasets/kubric.py:110-152,176-179`: frames/*.png +
    depths/*.png, one `<scene>_dense.npy` dict per scene holding stacked
    `intrinsics`, Blender `matrix_world` (converted via the
    Blender->OpenCV column flip) and a `depth_range` used to decode
    uint16 depth as min + raw*(max-min)/65535; z_far 1000."""

    dataset_label = "Kubric"
    color_dir = "frames"
    color_ext = "*.png"
    depth_dir = "depths"
    z_far_default = 1000.0
    # Blender camera looks down -Z with +Y up; OpenCV looks down +Z with
    # -Y up -> flip the Y/Z basis columns (`kubric.py:34-36,141`)
    pose_postmul = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    aux_list_names = ("depth_ranges",)

    def __init__(self, *args, **kwargs):
        self.depth_ranges = []
        super().__init__(*args, **kwargs)

    def _scan_sequence(self, seq):
        scene = os.path.basename(os.path.normpath(seq))
        anno_path = os.path.join(seq, f"{scene}_dense.npy")
        rgb_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_dir, self.color_ext))
        )
        depth_paths = sorted(
            _glob.glob(os.path.join(seq, self.depth_dir, "*.png"))
        )
        if (not rgb_paths or len(rgb_paths) < self.min_frames
                or not os.path.exists(anno_path)):
            return None
        cam = np.load(anno_path, allow_pickle=True).item()
        cams = []
        for K, world in zip(cam["intrinsics"], cam["matrix_world"]):
            pose = self._fix_pose(np.asarray(world, np.float32))
            cams.append((pose, np.asarray(K, np.float32)))
        lo, hi = cam["depth_range"]
        self.depth_ranges.extend([(float(lo), float(hi))] * len(rgb_paths))
        return rgb_paths, depth_paths, cams, None

    def _load_depth_for(self, i):
        raw = imread_unchanged(self.all_depth_paths[i])
        if raw.ndim == 3:
            raw = raw[..., 0]
        lo, hi = self.depth_ranges[i]
        depth = lo + raw.astype(np.float32) * (hi - lo) / 65535.0
        depth[~np.isfinite(depth)] = 0
        from iggt_official_tpu_torch.data.base import threshold_depth_map

        return threshold_depth_map(
            depth, max_percentile=self.depth_percentile, min_percentile=-1
        )


class MapFree(SceneDirDataset):
    """`iggt/datasets/mapfree.py:121-155,230-243`: <seq>/<sub>/ nesting,
    rgb *.jpg + depth *.npy + cam npz (`pose`/`intrinsic`); depth is
    zeroed where the sky-mask jpg is nonzero and thresholded at the 98th
    percentile."""

    dataset_label = "MapFree"
    color_dir = "rgb"
    depth_dir = "depth"
    depth_ext = "*.npy"
    depth_mode = "npy"
    seq_depth = 2
    depth_percentile = 98
    aux_list_names = ("all_sky_paths",)

    def __init__(self, *args, **kwargs):
        self.all_sky_paths = []
        super().__init__(*args, **kwargs)

    def _scan_sequence(self, seq):
        scanned = super()._scan_sequence(seq)
        # reject short sequences here so all_sky_paths stays index-aligned
        if scanned is None or len(scanned[0]) < self.min_frames:
            return None
        sky = sorted(_glob.glob(os.path.join(seq, "sky_mask", "*.jpg")))
        n = len(scanned[0])
        self.all_sky_paths.extend(sky if len(sky) == n else [None] * n)
        return scanned

    def _load_depth_for(self, i):
        depth = super()._load_depth_for(i)
        sky_path = self.all_sky_paths[i]
        if sky_path is not None and os.path.exists(sky_path):
            sky = imread_grayscale(sky_path)
            if sky is not None and sky.shape == depth.shape:
                # `mapfree.py:239-240`: keep depth only where mask == 0
                depth = depth.copy()
                depth[sky != 0] = 0
        return depth


class MegaDepth(SceneDirDataset):
    """`iggt/datasets/megadepth.py:116-141,219-221`: <seq>/<sub>/ nesting,
    rgb *.jpg + exr depth (95th-percentile threshold) + per-frame npz in
    the rgb dir (`cam2world`/`intrinsics`), min 24 frames, z_far 1000."""

    dataset_label = "MegaDepth"
    color_dir = "rgb"
    depth_dir = "depth"
    depth_ext = "*.exr"
    depth_mode = "exr"
    seq_depth = 2
    depth_percentile = 95
    z_far_default = 1000.0
    pose_keys = ("cam2world",)

    def _scan_sequence(self, seq):
        rgb_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_dir, self.color_ext))
        )
        depth_paths = sorted(
            _glob.glob(os.path.join(seq, self.depth_dir, self.depth_ext))
        )
        # `megadepth.py:127,134`: camera npz files live in the rgb dir
        cam_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_dir, "*.npz"))
        )
        if not rgb_paths or len(cam_paths) != len(rgb_paths):
            return None
        cams = [self._load_cam(p) for p in cam_paths]
        return rgb_paths, depth_paths, cams, None


class Mp3d(SceneDirDataset):
    """`iggt/datasets/mp3d.py:107-135`: rgb/*.png + depth/*.npy +
    cam/*.npz, z_far 100."""

    dataset_label = "Mp3d"
    color_dir = "rgb"
    color_ext = "*.png"
    depth_mode = "npy"
    depth_ext = "*.npy"


class MvsSynth(SceneDirDataset):
    """`iggt/datasets/mvs_synth.py`: exr float depth."""

    dataset_label = "Mvs_Synth"
    depth_mode = "exr"
    depth_ext = "*.exr"


class PointOdyssey(SceneDirDataset):
    """`iggt/datasets/pointodyssey.py:95-110,160-174`: rgbs/*.jpg +
    depths/*.png (uint16 / 65535 * 1000 m), one `anno.npz` per sequence
    with stacked world->cam `extrinsics` (inverted to c2w at load) and
    `pix_T_cams` intrinsics; z_far 80."""

    dataset_label = "PointOdyssey"
    color_dir = "rgbs"
    depth_dir = "depths"
    depth_mode = "png_maxdepth"
    max_depth = 1000.0
    invert_pose = True
    z_far_default = 80.0

    def _scan_sequence(self, seq):
        rgb_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_dir, self.color_ext))
        )
        depth_paths = sorted(
            _glob.glob(os.path.join(seq, self.depth_dir, "*.png"))
        )
        anno_path = os.path.join(seq, "anno.npz")
        if not rgb_paths or not os.path.exists(anno_path):
            return None
        anno = np.load(anno_path)
        extr = anno["extrinsics"].astype(np.float32)
        intr = anno["pix_T_cams"].astype(np.float32)
        if len(extr) != len(rgb_paths):
            return None
        cams = [
            (self._fix_pose(extr[i]), intr[i]) for i in range(len(extr))
        ]
        return rgb_paths, depth_paths, cams, None


class Sintel(SceneDirDataset):
    """`iggt/datasets/sintel.py:93-133,185-214`: frame_*.png rgb +
    frame_*.dpt TAG_FLOAT depth + frame_*.cam cameras (w2c N matrix,
    inverted to c2w), with `dynamic_label_perfect` masks attached as
    ``dynamic_mask``."""

    dataset_label = "Sintel"
    min_frames = 2
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    color_ext = "frame_*.png"
    load_dynamic_mask = True
    aux_list_names = ("all_dyn_paths",)

    def __init__(self, dataset_location: str, dset: str = "clean",
                 *args, **kwargs):
        # explicit positional signature: `Sintel(root, "final")` must bind
        # dset once (a bare *args + dset keyword forwards it twice)
        self._dset_name = dset
        self.all_dyn_paths = []
        super().__init__(dataset_location, dset, *args, **kwargs)

    def _scan_sequence(self, seq):
        from iggt_official_tpu_torch.eval.trajectory import sintel_cam_read

        rgb_paths = sorted(
            _glob.glob(os.path.join(seq, self.color_ext))
        )
        depth_dir = _replace_component(seq, self._dset_name, "depth")
        cam_dir = _replace_component(seq, self._dset_name, "camdata_left")
        depth_paths = sorted(
            _glob.glob(os.path.join(depth_dir, "frame_*.dpt"))
        )
        cam_paths = sorted(
            _glob.glob(os.path.join(cam_dir, "frame_*.cam"))
        )
        if (not rgb_paths or len(rgb_paths) < self.min_frames
                or len(cam_paths) != len(rgb_paths)):
            return None
        cams = []
        for p in cam_paths:
            K, N = sintel_cam_read(p)
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3] = N
            pose = np.linalg.inv(w2c).astype(np.float32)
            cams.append((pose, K.astype(np.float32)))
        dyn_dir = _replace_component(
            seq, self._dset_name, "dynamic_label_perfect"
        )
        dyn = sorted(_glob.glob(os.path.join(dyn_dir, "frame_*.png")))
        n = len(rgb_paths)
        self.all_dyn_paths.extend(dyn if len(dyn) == n else [None] * n)
        return rgb_paths, depth_paths, cams, None

    def _read_depth(self, path, max_depth=None):
        from iggt_official_tpu_torch.data.base import threshold_depth_map

        depth = sintel_depth_read(path)
        depth[~np.isfinite(depth)] = 0
        return threshold_depth_map(
            depth, max_percentile=self.depth_percentile, min_percentile=-1
        )

    def _get_views(self, index, num, resolution, rng):
        views = super()._get_views(index, num, resolution, rng)
        if not self.load_dynamic_mask:
            return views
        for view in views:
            dyn_path = self.all_dyn_paths[view["frame_index"]]
            H, W = view["depthmap"].shape
            if dyn_path is None or not os.path.exists(dyn_path):
                view["dynamic_mask"] = np.ones((H, W), bool)
                continue
            import PIL.Image

            m = np.asarray(
                PIL.Image.open(dyn_path).convert("L"), np.float32
            ) / 255.0
            ys = (np.linspace(0, m.shape[0] - 1, H)).astype(int)
            xs = (np.linspace(0, m.shape[1] - 1, W)).astype(int)
            view["dynamic_mask"] = m[ys][:, xs] > 0.5
        return views


def _replace_component(path: str, old: str, new: str) -> str:
    parts = os.path.normpath(path).split(os.sep)
    parts = [new if p == old else p for p in parts]
    head = os.sep if os.path.isabs(path) else ""
    return head + os.path.join(*[p for p in parts if p])


_SINTEL_TAG = 202021.25  # `sintel.py:20` TAG_FLOAT


def sintel_depth_read(path: str) -> np.ndarray:
    """Sintel `.dpt` depth (`sintel.py:24-34`): TAG_FLOAT, w, h, f32."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        assert abs(tag - _SINTEL_TAG) < 1e-3, f"bad .dpt tag in {path}"
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        return np.fromfile(f, np.float32, w * h).reshape(h, w)


def sintel_depth_write(path: str, depth: np.ndarray) -> None:
    """Inverse of :func:`sintel_depth_read` (test fixture helper)."""
    h, w = depth.shape
    with open(path, "wb") as f:
        np.asarray([_SINTEL_TAG], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        depth.astype(np.float32).tofile(f)


class Spring(SceneDirDataset):
    """`iggt/datasets/spring.py:107-135`: rgb/*.png + depth/*.npy +
    cam/*.npz, z_far 200."""

    dataset_label = "Spring"
    color_dir = "rgb"
    color_ext = "*.png"
    depth_mode = "npy"
    depth_ext = "*.npy"
    z_far_default = 200.0


class TarTanAir(SceneDirDataset):
    """`iggt/datasets/tartanair.py:116-145`: flat sequence dirs with
    *.png rgb, *depth.npy depth and per-frame npz
    (`camera_pose`/`camera_intrinsics`)."""

    dataset_label = "TarTanAir"
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    color_ext = "*.png"
    depth_ext = "*depth.npy"
    depth_mode = "npy"
    pose_keys = ("camera_pose",)


class Uasol(SceneDirDataset):
    """`iggt/datasets/uasol.py:107-135`: rgb/*.png + depth/*.npy +
    cam/*.npz, z_far 20."""

    dataset_label = "Uasol"
    color_dir = "rgb"
    color_ext = "*.png"
    depth_mode = "npy"
    depth_ext = "*.npy"
    z_far_default = 20.0


class Unreal4k(SceneDirDataset):
    """`iggt/datasets/unreal4k.py:113-141`: <seq>/<sub>/ flat dirs with
    *.png rgb + *.npy depth + npz `cam2world` premultiplied by the
    x<->y axis swap `R_conv` (`unreal4k.py:25,140`), z_far 1000."""

    dataset_label = "Unreal4k"
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    color_ext = "*.png"
    depth_ext = "*.npy"
    depth_mode = "npy"
    seq_depth = 2
    z_far_default = 1000.0
    pose_keys = ("cam2world",)
    pose_premul = np.array(
        [[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    )


class Vkitti(SceneDirDataset):
    """`iggt/datasets/vkitti.py:109-145,225-235`: 3-level scene nesting,
    flat dirs with *.jpg rgb and `*depth.png` cm-scaled uint16 depth where
    readings >= 655 m mark sky (set to -1), npz
    `camera_pose`/`camera_intrinsics`, z_far 655."""

    dataset_label = "Vkitti"
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    color_ext = "*.jpg"
    depth_ext = "*depth.png"
    depth_scale = 100.0
    seq_depth = 3
    z_far_default = 655.0
    pose_keys = ("camera_pose",)

    def _read_depth(self, path, max_depth=None):
        from iggt_official_tpu_torch.data.base import threshold_depth_map

        raw = imread_anydepth(path)
        depth = raw.astype(np.float32) / self.depth_scale
        sky = depth >= 655
        depth[~np.isfinite(depth)] = 0
        depth = threshold_depth_map(
            depth, max_percentile=self.depth_percentile, min_percentile=-1
        )
        depth[sky] = -1.0  # `vkitti.py:232-233` sky sentinel
        return depth


class Waymo(SceneDirDataset):
    """`iggt/datasets/waymo.py:107-135`: flat sequence dirs with *.jpg
    rgb + *.exr depth + npz `cam2world`/`intrinsics`, z_far 655."""

    dataset_label = "Waymo"
    color_dir = ""
    depth_dir = ""
    cam_dir = ""
    depth_ext = "*.exr"
    depth_mode = "exr"
    z_far_default = 655.0
    pose_keys = ("cam2world",)


class Wildrgb(SceneDirDataset):
    """`iggt/datasets/wildrgb.py:116-147,228-231`: <seq>/scenes/<sub>/
    nesting with rgb *.jpg, depth *.png mm/1000 and metadata npz
    (`camera_pose`/`camera_intrinsics`), z_far 50."""

    dataset_label = "Wildrgb"
    color_dir = "rgb"
    cam_dir = "metadata"
    seq_glob = os.path.join("*", "scenes", "*")
    z_far_default = 50.0
    pose_keys = ("camera_pose",)


class Dl3dv(MaskletMixin, SceneDirDataset):
    """`iggt/datasets/dl3dv.py`: dense/{rgb,depth,cam} layout with npy
    depth, sky/outlier validity masks and SAM2 masklet pseudo-GT
    (`dl3dv.py:241-451`, via MaskletMixin)."""

    dataset_label = "Dl3dv"
    color_dir = os.path.join("dense", "rgb")
    depth_dir = os.path.join("dense", "depth")
    cam_dir = os.path.join("dense", "cam")
    color_ext = "*.png"
    depth_ext = "*.npy"
    depth_mode = "npy"
    depth_percentile = 98


class Dl3dvNew(Dl3dv):
    """`iggt/datasets/dl3dv_new.py`."""

    dataset_label = "Dl3dv_new"


DATASETS: Dict[str, Type[SceneDirDataset]] = {
    cls.dataset_label: cls
    for cls in [
        ARKitScenes, ARKitScenesHigh, Bedlam, BlendedMVS, Carla, Co3d, Cop3d,
        Dl3dv, Dl3dvNew, DynamicReplica, Habitat, Hypersim, Infinigen, Kubric,
        ScannetppV2,
        MapFree, MegaDepth, Mp3d, MvsSynth, PointOdyssey, Re10K, Replica,
        Scannet, Scannetpp, Sintel, Spring, TarTanAir, Uasol, Unreal4k,
        Vkitti, Waymo, Wildrgb,
    ]
}
