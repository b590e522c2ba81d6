"""Directory-contract scene datasets (ScanNet-style layout and variants).

Counterpart of `iggt_official_tpu/data/scene_dataset.py`, copied, with the
depth PNGs decoded by PIL (`data/imread.py`, byte-equal to cv2's
``IMREAD_UNCHANGED``) instead of cv2, and EXR depth by the port's own
OpenEXR reader (`data/imread.py::read_exr`).  The shipped per-dataset loaders of the reference all follow one
pattern -- scan sequence dirs, load per-frame pose npz + 16-bit depth PNG +
RGB, rank frames by extrinsic covisibility, and at `_get_views` time return
the anchor plus sampled top-k covisible frames.  `SceneDirDataset`
implements that pattern once over the documented layout:

    root/<split>/<sequence>/
        color/XXXX.jpg   depth/XXXX.png   cam/XXXX.npz (pose 4x4, intrinsics 3x3)

and the named subclasses (`data/datasets.py`) bind the per-dataset knobs.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import PIL.Image

from iggt_official_tpu_torch.data.base import BaseViewDataset, threshold_depth_map
from iggt_official_tpu_torch.data.imread import imread_unchanged
from iggt_official_tpu_torch.data.ranking import compute_ranking


class SceneDirDataset(BaseViewDataset):
    dataset_label = "SceneDir"
    # sub-dirs under each sequence dir; "" = flat layout where rgb/depth/cam
    # files share the sequence dir itself (hypersim/waymo/vkitti-style)
    color_dir = "color"
    depth_dir = "depth"
    cam_dir = "cam"
    color_ext = "*.jpg"
    depth_ext = "*.png"
    cam_ext = "*.npz"
    # depth decoding: "png_scale" (uint16 / depth_scale), "png_maxdepth"
    # (uint16 / 65535 * max_depth, hypersim-style), "npy", "pfm", "exr"
    depth_mode = "png_scale"
    depth_scale = 1000.0  # raw / scale = meters
    max_depth = 100.0     # used by png_maxdepth
    depth_percentile = 99
    # camera npz keys: a 4x4 pose under any of pose_keys, or split R/t
    pose_key = "pose"  # back-compat single-key override
    pose_keys = ("pose", "cam2world", "camera_pose")
    rot_key = "R_cam2world"
    trans_key = "t_cam2world"
    intr_keys = ("intrinsics", "intrinsic", "camera_intrinsics")
    # optional pose fixups applied at scan time: premul @ pose @ postmul,
    # then inversion when the file stores world->cam (pointodyssey-style)
    pose_premul: Optional[np.ndarray] = None
    pose_postmul: Optional[np.ndarray] = None
    invert_pose = False
    min_frames = 24
    # per-dataset default z_far (each reference loader hard-codes its own:
    # arkitscenes 20, hypersim/bedlam/spring 200, waymo/vkitti 655, ...)
    z_far_default = 100.0
    # nesting level of sequence dirs under root/<dset> (co3d's
    # category/sequence layout uses 2, `co3d.py:107-121`); seq_glob
    # overrides the whole pattern (wildrgb's `*/scenes/*`)
    seq_depth = 1
    seq_glob: Optional[str] = None
    # scene names to skip outright (hypersim's broken_scenes list,
    # `hypersim.py:25-45`); matched against any path component
    skip_scenes: frozenset = frozenset()
    # per-frame maximum-depth npz key for png_maxdepth decoding
    # (co3d's `maximum_depth`, `co3d.py:154,176-179`)
    max_depth_key: Optional[str] = None
    # names of auxiliary per-frame lists a subclass's _scan_sequence
    # extends alongside the index (Kubric.depth_ranges,
    # MapFree.all_sky_paths, ...); persisted with the startup cache so a
    # cache hit restores them index-aligned instead of leaving them empty
    aux_list_names: tuple = ()

    def __init__(
        self,
        dataset_location: str,
        dset: str = "scans",
        top_k: int = 256,
        z_far: Optional[float] = None,
        quick: bool = False,
        specify: bool = False,
        use_cache: bool = False,
        cache_root: str = "annotations",
        **kwargs,
    ):
        super().__init__(
            z_far=self.z_far_default if z_far is None else z_far, **kwargs
        )
        self.dataset_location = dataset_location
        self.dset = dset
        self.top_k = top_k
        self.specify = specify

        self.full_idxs: List[int] = []
        self.all_rgb_paths: List[str] = []
        self.all_depth_paths: List[str] = []
        self.all_extrinsic: List[np.ndarray] = []
        self.all_intrinsic: List[np.ndarray] = []
        self.max_depths: List[float] = []
        self.rank: Dict[int, np.ndarray] = {}

        # reference-style startup index cache
        # (`scannet.py:86-101,155-159`: rgb/depth path json + joblib
        # extrinsics/intrinsics/rankings under annotations/<label>/<dset>;
        # here one npz replaces the joblib files)
        self._cache_dir = os.path.join(
            cache_root, f"{self.dataset_label.lower()}_annotations", dset
        )
        if use_cache and self._load_cache():
            return

        root = os.path.join(dataset_location, dset)
        sub = self.seq_glob or os.path.join(*(["*"] * self.seq_depth))
        sequences = sorted(glob.glob(os.path.join(root, sub) + os.sep))
        if quick:
            sequences = sequences[:1]

        for seq in sequences:
            parts = set(os.path.normpath(seq).split(os.sep))
            if parts & self.skip_scenes:
                print(f"Skipping broken scene: {seq}")
                continue
            scanned = self._scan_sequence(seq)
            if scanned is None:
                continue
            rgb_paths, depth_paths, cams, max_depths = scanned
            if len(rgb_paths) < self.min_frames:
                continue
            assert len(rgb_paths) == len(depth_paths) == len(cams), seq

            base = len(self.full_idxs)
            self.full_idxs.extend(range(base, base + len(rgb_paths)))
            self.all_rgb_paths.extend(rgb_paths)
            self.all_depth_paths.extend(depth_paths)
            self.max_depths.extend(
                max_depths if max_depths is not None
                else [self.max_depth] * len(rgb_paths)
            )

            extrinsics_seq = []
            for pose, K in cams:
                self.all_extrinsic.append(pose)
                self.all_intrinsic.append(K)
                extrinsics_seq.append(pose)

            ranking, _ = compute_ranking(
                np.stack(extrinsics_seq), lambda_t=1.0, normalize=True
            )
            ranking = ranking.astype(np.int32) + base
            for ind, i in enumerate(range(base, len(self.full_idxs))):
                # drop self (rank position 0 is the frame itself)
                self.rank[i] = ranking[ind][1:]

        if use_cache:
            self._save_cache()

    # -- sequence scanning (overridable per layout) --------------------
    def _scan_sequence(self, seq: str):
        """-> (rgb_paths, depth_paths, [(pose, K)...], max_depths|None)
        for one sequence dir, or None to skip it."""
        rgb_paths = sorted(
            glob.glob(os.path.join(seq, self.color_dir, self.color_ext))
        )
        depth_paths = sorted(
            glob.glob(os.path.join(seq, self.depth_dir, self.depth_ext))
        )
        cam_paths = sorted(
            glob.glob(os.path.join(seq, self.cam_dir, self.cam_ext))
        )
        # reject too-short sequences before paying the camera-file parse
        # (the base __init__ would drop them post-scan anyway)
        if not rgb_paths or len(rgb_paths) < self.min_frames:
            return None
        cams = []
        max_depths = [] if self.max_depth_key else None
        for cam_path in cam_paths:
            if max_depths is not None:
                with np.load(cam_path) as cam:
                    pose, K = self._load_cam(cam_path, cam=cam)
                    max_depths.append(
                        float(np.nan_to_num(cam[self.max_depth_key]))
                        if self.max_depth_key in cam
                        else self.max_depth
                    )
            else:
                pose, K = self._load_cam(cam_path)
            cams.append((pose, K))
        return rgb_paths, depth_paths, cams, max_depths

    # -- index cache ---------------------------------------------------
    def _cache_paths(self):
        import json

        return (
            os.path.join(self._cache_dir, "rgb_paths.json"),
            os.path.join(self._cache_dir, "depth_paths.json"),
            os.path.join(self._cache_dir, "index.npz"),
            os.path.join(self._cache_dir, "aux_lists.json"),
        )

    def _load_cache(self) -> bool:
        import json

        rgb_f, depth_f, arr_f, aux_f = self._cache_paths()
        if not (os.path.exists(rgb_f) and os.path.exists(arr_f)):
            return False
        # parse everything into locals first; commit to self only once the
        # whole cache validates, so a False return leaves the instance
        # clean for the fallback directory rescan
        with open(rgb_f, encoding="utf-8") as f:
            rgb = json.load(f)
        rgb_paths = [rgb[str(i)] for i in range(len(rgb))]
        aux: Dict[str, list] = {}
        if self.aux_list_names:
            # stale cache written before this subclass persisted its
            # auxiliary per-frame lists -> rescan rather than desync
            if not os.path.exists(aux_f):
                return False
            with open(aux_f, encoding="utf-8") as f:
                aux = json.load(f)
            for name in self.aux_list_names:
                if name not in aux or len(aux[name]) != len(rgb_paths):
                    return False
        with open(depth_f, encoding="utf-8") as f:
            dep = json.load(f)
        self.all_rgb_paths = rgb_paths
        self.all_depth_paths = [dep[str(i)] for i in range(len(dep))]
        arrs = np.load(arr_f)
        self.all_extrinsic = list(arrs["extrinsics"].astype(np.float32))
        self.all_intrinsic = list(arrs["intrinsics"].astype(np.float32))
        self.max_depths = list(arrs["max_depths"].astype(np.float64))
        lengths = arrs["rank_lengths"]
        flat = arrs["rank_flat"]
        off = 0
        for i, n in enumerate(lengths):
            self.rank[i] = flat[off : off + n]
            off += n
        self.full_idxs = list(range(len(self.all_rgb_paths)))
        for name in self.aux_list_names:
            # json round-trips tuples (kubric depth ranges) as lists;
            # consumers unpack them positionally either way
            setattr(self, name, [
                tuple(v) if isinstance(v, list) else v for v in aux[name]
            ])
        return True

    def _save_cache(self) -> None:
        import json

        os.makedirs(self._cache_dir, exist_ok=True)
        rgb_f, depth_f, arr_f, aux_f = self._cache_paths()
        if self.aux_list_names:
            with open(aux_f, "w", encoding="utf-8") as f:
                json.dump(
                    {n: list(getattr(self, n)) for n in self.aux_list_names},
                    f,
                )
        with open(rgb_f, "w", encoding="utf-8") as f:
            json.dump({str(i): p for i, p in enumerate(self.all_rgb_paths)}, f)
        with open(depth_f, "w", encoding="utf-8") as f:
            json.dump(
                {str(i): p for i, p in enumerate(self.all_depth_paths)}, f
            )
        lengths = np.array(
            [len(self.rank[i]) for i in range(len(self.full_idxs))], np.int64
        )
        flat = (
            np.concatenate([self.rank[i] for i in range(len(self.full_idxs))])
            if len(self.full_idxs)
            else np.zeros(0, np.int32)
        )
        np.savez(
            arr_f,
            extrinsics=np.stack(self.all_extrinsic)
            if self.all_extrinsic else np.zeros((0, 4, 4), np.float32),
            intrinsics=np.stack(self.all_intrinsic)
            if self.all_intrinsic else np.zeros((0, 3, 3), np.float32),
            max_depths=np.asarray(self.max_depths, np.float64),
            rank_lengths=lengths,
            rank_flat=flat.astype(np.int32),
        )

    def __len__(self):
        return len(self.full_idxs)

    def _load_cam(self, cam_path: str, cam=None):
        if cam is None:
            cam = np.load(cam_path)
        pose = None
        for key in (self.pose_key, *self.pose_keys):
            if key in cam:
                pose = np.asarray(cam[key], np.float32)
                break
        if pose is None:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.asarray(cam[self.rot_key], np.float32)
            pose[:3, 3] = np.asarray(cam[self.trans_key], np.float32).ravel()
        K = None
        for key in self.intr_keys:
            if key in cam:
                K = np.asarray(cam[key], np.float32)
                break
        assert pose.shape == (4, 4) and K is not None and K.shape == (3, 3), cam_path
        return self._fix_pose(pose), K

    def _fix_pose(self, pose: np.ndarray) -> np.ndarray:
        """Dataset-convention fixups: unreal4k's axis swap
        (`unreal4k.py:25,140` `R_conv @ cam2world`), kubric's
        Blender->OpenCV postmul (`kubric.py:141-143`), pointodyssey's
        stored world->cam inversion (`pointodyssey.py:160-167`)."""
        if self.pose_premul is not None:
            pose = self.pose_premul @ pose
        if self.pose_postmul is not None:
            pose = pose @ self.pose_postmul
        if self.invert_pose:
            inv = np.eye(4, dtype=pose.dtype)
            inv[:3, :3] = pose[:3, :3].T
            inv[:3, 3] = -pose[:3, :3].T @ pose[:3, 3]
            pose = inv
        return pose.astype(np.float32)

    def _load_depth_for(self, i: int) -> np.ndarray:
        """Per-index depth hook so subclasses can fold in auxiliary files
        (mapfree's sky masks, infinigen's seg maps)."""
        return self._read_depth(
            self.all_depth_paths[i],
            max_depth=self.max_depths[i] if self.max_depths else None,
        )

    def _read_depth(self, path: str, max_depth: Optional[float] = None) -> np.ndarray:
        if self.depth_mode == "npy":
            depth = np.load(path).astype(np.float32)
        elif self.depth_mode == "pfm":
            depth = read_pfm(path).astype(np.float32)
        else:
            raw = imread_unchanged(path)
            if raw.ndim == 3:
                raw = raw[..., 0]
            if self.depth_mode == "png_maxdepth":
                md = self.max_depth if max_depth is None else max_depth
                depth = raw.astype(np.float32) / 65535.0 * md
            elif self.depth_mode == "exr":
                depth = raw.astype(np.float32)
            else:
                depth = raw.astype(np.float32) / self.depth_scale
        depth[~np.isfinite(depth)] = 0
        return threshold_depth_map(
            depth, max_percentile=self.depth_percentile, min_percentile=-1
        )

    def _get_views(self, index, num, resolution, rng):
        anchor = self.full_idxs[index]
        if num != 1:
            rest = self.rank[anchor][
                : min(self.top_k, len(self.rank[anchor]))
            ]
            if self.specify:
                step = max(1, len(rest) // (num - 1))
                others = [rest[i] for i in range(0, len(rest), step)][: num - 1]
            else:
                others = list(rng.choice(rest, size=num - 1, replace=False))
            full_idx = [anchor] + [int(i) for i in others]
        else:
            full_idx = [anchor]

        views = []
        for i in full_idx:
            image = PIL.Image.open(self.all_rgb_paths[i]).convert("RGB")
            depth = self._load_depth_for(i)
            K = self.all_intrinsic[i]
            image, depth, K = self._crop_resize_if_necessary(
                image, depth, K, resolution, rng=rng,
                info=self.all_rgb_paths[i],
            )
            views.append(
                dict(
                    img=image,
                    depthmap=depth,
                    camera_pose=self.all_extrinsic[i],
                    camera_intrinsics=K,
                    dataset=self.dataset_label,
                    label=self.all_rgb_paths[i].split(os.sep)[-3],
                    instance=os.path.basename(self.all_rgb_paths[i]),
                    frame_index=i,
                )
            )
        return views


def read_pfm(path: str) -> np.ndarray:
    """Minimal PFM reader (BlendedMVS-style depth maps)."""
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        assert header in ("PF", "Pf"), header
        dims = f.readline().decode().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode().rstrip())
        data = np.fromfile(f, "<f" if scale < 0 else ">f")
    channels = 3 if header == "PF" else 1
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.flipud(img).copy()


# Named dataset registry lives in iggt_official_tpu/data/datasets.py; the
# most common ones are re-exported here for convenience.
from iggt_official_tpu_torch.data.datasets import (  # noqa: E402,F401
    DATASETS,
    Dl3dv,
    Re10K,
    Scannet,
    Scannetpp,
)
