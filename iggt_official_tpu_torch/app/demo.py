"""Scene processing: images -> depth / points / poses / instance masks.

Counterpart of `iggt_official_tpu/app/demo.py` (`IGGTProcessor`): load and
resize the scene's images, one forward of the IGGT model (bf16 trunk through
the hand-written attention kernels, and with ``RuntimeConfig(fused_ln=True)``
its pre-norms through the fused LayerNorm kernel; with
``RuntimeConfig(global_merge_r=r)`` (``--merge_tokens r``) the global blocks
attend over K/V with r tokens merged away, `ops/token_merge.py`; with
``RuntimeConfig(use_flash_attention=False)`` the DINOv2, frame and global
blocks attend through plain torch, `layers/blocks.py::sdpa_plain`; decode heads in
``ModelConfig.head_dtype``, fp32 by default), then `_post_process`: decode
the poses, unproject the depth maps, normalize the part features and colour
them by PCA, smooth them over the world points (Morton-window kNN), and
cluster them jointly over all views into instance masks (subsampled weighted
HDBSCAN, 1-NN noise reassignment and backfill through the `nn1` kernel,
full-density boundary refinement), coloured with jet.  When the scene has
ground truth (``depth/`` 16-bit PNGs in millimetres and ``cam/`` npz files
with ``pose`` and ``intrinsics``, or ``gt_depth/`` and ``gt_cam/``), depth
and poses are evaluated against it into ``evaluation_report.json``.  Writes
``predictions.npz``, ``masks/mask_%04d.png``, ``pca/pca_%04d.png``, the
depth visualizations under ``depth_vis/`` (four colormaps per view, a scale
bar, a colormap comparison, a GIF, the depth maps and their statistics as
npy) and ``scene_{rgb,mask,pca}.glb``.  With ``RuntimeConfig(mask_sky=True)``
(``--mask_sky``) the GLB export multiplies the world-point confidence by
per-view sky keep-masks (`utils/sky.py`), read from
``<target_dir>/sky_masks/`` or computed and written there.

Usage:
    python -m iggt_official_tpu_torch.app.demo --target_dir <scene> \
        --save_dir out [--model_path weights.pt] [--preset large] \
        [--exact_clustering] [--image_size 504 336] [--conf_threshold 0.3] \
        [--merge_tokens R] [--mask_sky] [--head_dtype float32|bfloat16] \
        [--device cuda]

Weights are random (from a seed) unless ``--model_path`` names a checkpoint
in the reference layout: the published IGGT checkpoint (bare, wrapped in
``"model"`` or with a DDP ``module.`` prefix) or a state dict saved from this
package's model, whose names are the reference's.  `utils/checkpoint.py`
merges it by name with a shape check and logs what it matched, what it
dropped and what it could not use (`IGGTProcessor.load_report`).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from iggt_official_tpu_torch.config import (
    CLUSTERING_LARGE,
    CLUSTERING_MEDIUM,
    CLUSTERING_SMALL,
    ModelConfig,
    RuntimeConfig,
)
from iggt_official_tpu_torch.eval.metrics import SceneEvaluator
from iggt_official_tpu_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from iggt_official_tpu_torch.geometry.projection import (
    closed_form_inverse_se3,
    depth_to_world_coords_points,
    unproject_depth_map_to_point_map,
)
from iggt_official_tpu_torch.layers.blocks import sdpa_plain
from iggt_official_tpu_torch.models.vggt import IGGT, build_model
from iggt_official_tpu_torch.ops.cluster import cluster_features_to_masks_mv, trace_stage
from iggt_official_tpu_torch.ops.flash_attention import attention
from iggt_official_tpu_torch.ops.knn import knn_smooth_features
from iggt_official_tpu_torch.ops.pca import normalize_and_pca
from iggt_official_tpu_torch.ops.token_merge import merge_count, protected_tokens
from iggt_official_tpu_torch.utils.checkpoint import load_reference_state, read_checkpoint
from iggt_official_tpu_torch.utils.colormaps import get_cmap
from iggt_official_tpu_torch.utils.device import resolve_device
from iggt_official_tpu_torch.utils.glb import predictions_to_glb
from iggt_official_tpu_torch.utils.images import load_and_preprocess_images
from iggt_official_tpu_torch.utils.sky import load_or_compute_sky_masks

logger = logging.getLogger(__name__)

CLUSTERING_PRESETS = {
    "small": CLUSTERING_SMALL,
    "medium": CLUSTERING_MEDIUM,
    "large": CLUSTERING_LARGE,
}


def threshold_depth_map(
    depth_map: np.ndarray,
    max_percentile: float = 99,
    min_percentile: float = 1,
    max_depth: float = -1,
) -> np.ndarray:
    """Percentile depth thresholding, in place (`iggt/datasets/utils/misc.py:488-541`)."""
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


def read_depth_png(path: str) -> np.ndarray:
    """A 16-bit depth PNG as uint16 (Pillow opens one in mode "I;16")."""
    from PIL import Image

    with Image.open(path) as img:
        depth = np.asarray(img)
    if depth.dtype != np.uint16:
        raise ValueError(f"{path}: {depth.dtype} pixels, not a 16-bit depth PNG")
    return depth


def scene_image_paths(target_dir: str):
    paths = sorted(glob.glob(os.path.join(target_dir, "images", "*"))) or sorted(
        glob.glob(os.path.join(target_dir, "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no images under {target_dir}")
    return paths


class IGGTProcessor:
    """End-to-end scene processor.

    Runs on the card unless ``device="cpu"`` is passed.  On the card,
    fp32 matmuls and convolutions run in full fp32 (TF32 off), so the fp32
    heads compute what the CPU reference computes."""

    def __init__(self, model_path: Optional[str] = None,
                 model_cfg: Optional[ModelConfig] = None,
                 runtime: Optional[RuntimeConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.load_report = None
        self.cfg = model_cfg or ModelConfig()
        self.runtime = runtime or RuntimeConfig()
        self.evaluator = SceneEvaluator()
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = self._load_model(model_path, seed)

    def _load_model(self, model_path: Optional[str], seed: int) -> IGGT:
        model = build_model(self.cfg, self.device, seed=seed)
        if model_path is None:
            logger.warning("No checkpoint given: running with random weights (seed %d)", seed)
            return model
        self.load_report = load_reference_state(
            model, read_checkpoint(model_path), log=logger.info)
        return model

    def process_scene(self, target_dir: str, save_dir: str,
                      preds: Optional[Dict[str, Any]] = None,
                      gt_data: Optional[Dict[str, Any]] = None,
                      trace: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Forward, post-processing, evaluation against ground truth when the
        scene has it, and the exports.  Returns ``{"predictions": ...}``, plus
        ``"evaluation"`` with ground truth.  ``preds`` (`_run_inference`'s
        output) and ``gt_data`` (`_load_gt_data`'s) may come in computed
        already: `app/batch_eval.py` loads the next scene's ground truth and
        runs its forward on a worker thread while this one post-processes.
        A ``trace`` dict receives each stage's wall seconds (the device
        synchronized at its end), those of `_post_process` included."""
        t0 = time.perf_counter()
        os.makedirs(save_dir, exist_ok=True)
        if gt_data is None:
            gt_data = self._load_gt_data(target_dir)
            t0 = trace_stage(trace, "ground truth load", t0)
        if preds is None:
            preds = self._run_inference(target_dir)
            t0 = trace_stage(trace, "forward", t0, self.device)
        preds = self._post_process(preds, trace=trace)
        t0 = time.perf_counter()
        preds = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in preds.items()}
        t0 = trace_stage(trace, "device to host", t0)

        results: Dict[str, Any] = {"predictions": preds}
        if gt_data is not None:
            report = self.evaluator.evaluate_scene(
                gt_data, {"depth": preds["depth"][..., 0], "extrinsic": preds["extrinsic"]})
            self.evaluator.save_evaluation_report(
                report, os.path.join(save_dir, "evaluation_report.json"))
            self.evaluator.print_summary(report)
            results["evaluation"] = report
            t0 = trace_stage(trace, "evaluation", t0)
        self._save_predictions(preds, save_dir)
        t0 = trace_stage(trace, "npz + mask / PCA PNGs", t0)
        self._save_depth_visualizations(preds["depth"][..., 0], save_dir)
        t0 = trace_stage(trace, "depth_vis", t0)
        self._export_glbs(preds, save_dir, target_dir)
        trace_stage(trace, "GLB export", t0)
        return results

    @torch.inference_mode()
    def _run_inference(self, target_dir: str) -> Dict[str, Any]:
        W, H = self.runtime.image_size
        images = load_and_preprocess_images(
            scene_image_paths(target_dir), mode="resize", resize_target_size=(W, H))
        r = self.runtime.global_merge_r
        if r:
            agg = self.cfg.aggregator
            S, h, w = images.shape[:3]
            P = agg.patch_start_idx + (h // agg.patch_size) * (w // agg.patch_size)
            logger.info("token merging: r = %d of the %d requested (%d views of %d tokens)",
                        merge_count(r, protected_tokens(S, P, agg.patch_start_idx)), r, S, P)
        attn = {}
        if not self.runtime.use_flash_attention:
            attn = {"attn_fn": sdpa_plain, "part_attn_fn": attention}
        out = self.model(torch.from_numpy(images[None]).to(self.device),
                         fused_ln=self.runtime.fused_ln, global_merge_r=r, **attn)
        preds: Dict[str, Any] = {k: v for k, v in out.items() if k != "pose_enc_list"}
        preds["images"] = images
        return preds

    @torch.inference_mode()
    def _post_process(self, preds: Dict[str, Any],
                      trace: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        """Decode poses, unproject the depth maps (batch dim dropped), colour
        the part features by PCA, smooth them and cluster them into masks.

        Tensors stay on their device; the masks come back as numpy.  A
        ``trace`` dict receives each stage's wall seconds, the device
        synchronized at its end (`ops/cluster.py` module docstring)."""
        t0 = time.perf_counter()
        S, H, W = preds["images"].shape[:3]
        extri, intri = pose_encoding_to_extri_intri(preds["pose_enc"], (H, W))
        preds["extrinsic"] = extri[0]
        preds["intrinsic"] = intri[0]
        for k in ("depth", "depth_conf", "world_points", "world_points_conf", "part_feat"):
            if k in preds:
                preds[k] = preds[k][0]
        preds["world_points_from_depth"] = unproject_depth_map_to_point_map(
            preds["depth"], preds["extrinsic"], preds["intrinsic"])
        dev = preds["depth"].device
        t0 = trace_stage(trace, "poses + unprojection", t0, dev)

        if "part_feat" in preds:
            cc = self.runtime.clustering
            feat, preds["part_feat_pca"] = normalize_and_pca(preds["part_feat"])
            t0 = trace_stage(trace, "PCA", t0, dev)
            smoothed = knn_smooth_features(preds["world_points"], feat, k=cc.knn_k)
            del feat
            trace_stage(trace, "smoothing", t0, dev)
            preds["instance_masks"], preds["instance_masks_colored"] = (
                cluster_features_to_masks_mv(
                    smoothed, apply_colormap=True, eps=cc.eps,
                    min_samples=cc.min_samples,
                    min_cluster_size=cc.min_cluster_size, exact=cc.exact, trace=trace))
        return preds

    @staticmethod
    def _load_gt_data(target_dir: str) -> Optional[Dict[str, Any]]:
        """Ground truth, when the scene has it: per view a 16-bit depth PNG in
        millimetres and an npz with the camera-to-world ``pose`` (4, 4) and
        ``intrinsics`` (3, 3) (`demo.py:215-309` of the reference)."""
        images_dir = os.path.join(target_dir, "images")
        depth_dir = os.path.join(target_dir, "depth")
        cam_dir = os.path.join(target_dir, "cam")
        if not os.path.exists(depth_dir):
            depth_dir = os.path.join(target_dir, "gt_depth")
        if not os.path.exists(cam_dir):
            cam_dir = os.path.join(target_dir, "gt_cam")
        if not (os.path.exists(depth_dir) and os.path.exists(cam_dir)):
            return None

        image_paths = sorted(glob.glob(os.path.join(images_dir, "*")))
        depth_paths = sorted(glob.glob(os.path.join(depth_dir, "*.png")))
        cam_paths = sorted(glob.glob(os.path.join(cam_dir, "*.npz")))
        if not (len(image_paths) == len(depth_paths) == len(cam_paths)):
            logger.warning("GT file count mismatch: skipping evaluation")
            return None

        exts, ints, depths, worlds = [], [], [], []
        for depth_path, cam_path in zip(depth_paths, cam_paths):
            cam = np.load(cam_path)
            pose = np.asarray(cam["pose"], np.float32)
            K = np.asarray(cam["intrinsics"], np.float32)
            if pose.shape != (4, 4) or K.shape != (3, 3):
                raise ValueError(f"{cam_path}: pose {pose.shape}, intrinsics {K.shape}")
            depth = read_depth_png(depth_path).astype(np.float32) / 1000.0
            depth[~np.isfinite(depth)] = 0
            depth = threshold_depth_map(depth, max_percentile=99, min_percentile=-1)
            camera_pose = closed_form_inverse_se3(torch.from_numpy(pose[None]))[0].numpy()
            world, _, _ = depth_to_world_coords_points(
                torch.from_numpy(depth), torch.from_numpy(camera_pose[:3]),
                torch.from_numpy(K))
            exts.append(camera_pose[:3])
            ints.append(K)
            depths.append(depth)
            worlds.append(world.numpy())
        return {
            "gt_extrinsic": np.stack(exts),
            "gt_intrinsic": np.stack(ints),
            "gt_depth": np.stack(depths),
            "gt_world_points": np.stack(worlds),
            "image_paths": image_paths,
        }

    @staticmethod
    def _save_predictions(preds: Dict[str, np.ndarray], save_dir: str) -> None:
        """``predictions.npz`` and one PNG per view of the coloured masks and
        of the PCA colours (the depth visualizations are written next)."""
        from PIL import Image

        np.savez(os.path.join(save_dir, "predictions.npz"), **preds)
        pngs = (("instance_masks_colored", "masks", "mask", lambda f: f),
                ("part_feat_pca", "pca", "pca", lambda f: (f * 255).astype(np.uint8)))
        for key, sub, stem, to_uint8 in pngs:
            if key not in preds:
                continue
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)
            for i, frame in enumerate(preds[key]):
                Image.fromarray(to_uint8(frame)).save(
                    os.path.join(save_dir, sub, f"{stem}_{i:04d}.png"))

    @classmethod
    def _save_depth_visualizations(cls, depths: np.ndarray, save_dir: str) -> None:
        """Percentile-normalized colormap PNGs (`demo.py:435-609` of the
        reference): per view a PNG in each of jet, viridis, plasma and turbo,
        the jet one again plain and with a scale bar; the colormap comparison
        of view 0; depth statistics and the depth maps as npy; a GIF across
        views."""
        from PIL import Image

        depth_dir = os.path.join(save_dir, "depth_vis")
        os.makedirs(depth_dir, exist_ok=True)

        valid = depths[depths > 0]
        if valid.size == 0:
            logger.warning("No valid depth values found!")
            return
        lo, hi = np.percentile(valid, [1, 99])
        np.save(
            os.path.join(depth_dir, "depth_statistics.npy"),
            {
                "min": float(lo), "max": float(hi),
                "mean": float(valid.mean()), "std": float(valid.std()),
                "percentile_1": float(lo), "percentile_99": float(hi),
                "valid_pixel_ratio": float(valid.size / depths.size),
            },
        )

        vis_modes = ["jet", "viridis", "plasma", "turbo"]
        cmaps = {m: get_cmap(m) for m in vis_modes}
        frames = []
        for i, d in enumerate(depths):
            normed = np.clip((d - lo) / max(hi - lo, 1e-12), 0, 1)
            per_mode = {}
            for mode in vis_modes:
                rgb = (cmaps[mode](normed) * 255).astype(np.uint8)
                per_mode[mode] = rgb
                Image.fromarray(rgb).save(os.path.join(depth_dir, f"depth_{i:04d}_{mode}.png"))
            primary = per_mode[vis_modes[0]]
            Image.fromarray(primary).save(os.path.join(depth_dir, f"depth_{i:04d}.png"))
            frames.append(Image.fromarray(primary))
            cls._add_depth_scale_bar(
                primary, lo, hi, cmaps[vis_modes[0]],
                os.path.join(depth_dir, f"depth_{i:04d}_with_scale.png"))
            if i == 0:
                grid = np.concatenate([per_mode[m] for m in vis_modes], axis=1)
                Image.fromarray(grid).save(os.path.join(depth_dir, "colormap_comparison.png"))
        np.save(os.path.join(depth_dir, "depth.npy"), depths)
        if len(frames) > 1:
            frames[0].save(os.path.join(depth_dir, "depth_animation.gif"),
                           save_all=True, append_images=frames[1:], duration=200, loop=0)

    @staticmethod
    def _add_depth_scale_bar(rgb, depth_min, depth_max, cmap, save_path) -> None:
        """Append a horizontal colorbar with min / max labels."""
        from PIL import Image, ImageDraw

        h, w = rgb.shape[:2]
        bar_h = 20
        ramp = np.linspace(0, 1, w, dtype=np.float32)
        bar = (cmap(np.tile(ramp, (bar_h, 1))) * 255).astype(np.uint8)
        canvas = np.concatenate([rgb, np.zeros((bar_h + 14, w, 3), np.uint8)])
        canvas[h:h + bar_h] = bar
        img = Image.fromarray(canvas)
        draw = ImageDraw.Draw(img)
        draw.text((2, h + bar_h + 1), f"{depth_min:.2f}m", fill=(255,) * 3)
        label = f"{depth_max:.2f}m"
        draw.text((w - 8 * len(label), h + bar_h + 1), label, fill=(255,) * 3)
        img.save(save_path)

    def _export_glbs(self, preds: Dict[str, np.ndarray], save_dir: str,
                     target_dir: Optional[str] = None) -> None:
        """rgb | mask | pca point clouds with camera markers as GLB
        (`demo.py:618-657` of the reference), points below the
        ``conf_threshold`` percentile of confidence dropped; with
        ``mask_sky``, sky pixels' confidence is zeroed first, so the
        percentile filter drops them (`visual_util.py:112-159`)."""
        conf = preds.get("world_points_conf")
        if self.runtime.mask_sky and target_dir is not None and conf is not None:
            conf = conf * load_or_compute_sky_masks(target_dir, conf.shape[-2:])
        modes = {"rgb": preds["images"]}
        if "instance_masks_colored" in preds:
            modes["mask"] = preds["instance_masks_colored"].astype(np.float32) / 255
        if "part_feat_pca" in preds:
            modes["pca"] = preds["part_feat_pca"]
        for name, colors in modes.items():
            predictions_to_glb(
                preds["world_points"], colors, conf=conf,
                extrinsics=preds.get("extrinsic"),
                conf_threshold=self.runtime.conf_threshold,
                path=os.path.join(save_dir, f"scene_{name}.glb"))


def main() -> None:
    parser = argparse.ArgumentParser(description="IGGT scene processing (PyTorch / CUDA)")
    parser.add_argument("--target_dir", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--preset", default="large", choices=list(CLUSTERING_PRESETS))
    parser.add_argument("--exact_clustering", action="store_true",
                        help="run the weighted HDBSCAN at full pixel density "
                             "(minutes at demo scale) instead of the subsampled path")
    parser.add_argument("--image_size", type=int, nargs=2, default=(504, 336),
                        metavar=("W", "H"))
    parser.add_argument("--conf_threshold", type=float, default=0.3,
                        help="GLB export: drop points below this percentile of "
                             "confidence")
    parser.add_argument("--merge_tokens", type=int, default=0,
                        help="merge this many K/V tokens out of every global "
                             "attention block (FastVGGT-style); 0 = exact")
    parser.add_argument("--mask_sky", action="store_true",
                        help="drop sky pixels from the GLB point clouds (per-view "
                             "masks cached under <target_dir>/sky_masks)")
    parser.add_argument("--head_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="decode-head compute dtype: float32 is the "
                             "reference's fp32 island, bfloat16 the fast mode")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    runtime = RuntimeConfig(
        image_size=tuple(args.image_size),
        conf_threshold=args.conf_threshold,
        clustering=dataclasses.replace(CLUSTERING_PRESETS[args.preset],
                                       exact=args.exact_clustering),
        global_merge_r=args.merge_tokens, mask_sky=args.mask_sky)
    model_cfg = dataclasses.replace(ModelConfig(), head_dtype=args.head_dtype)
    processor = IGGTProcessor(args.model_path, model_cfg=model_cfg, runtime=runtime,
                              device=args.device)
    preds = processor.process_scene(args.target_dir, args.save_dir)["predictions"]
    logger.info("wrote %s (%d views)", os.path.join(args.save_dir, "predictions.npz"),
                preds["images"].shape[0])


if __name__ == "__main__":
    main()
