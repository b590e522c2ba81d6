"""Scene processing: images -> depth / points / poses / instance masks.

Counterpart of `iggt_official_tpu/app/demo.py` (`IGGTProcessor`): load and
resize the scene's images, one forward of the IGGT model (bf16 trunk through
the hand-written attention kernels, fp32 heads), then `_post_process`: decode
the poses, unproject the depth maps, normalize the part features and colour
them by PCA, smooth them over the world points (Morton-window kNN), and
cluster them jointly over all views into instance masks (subsampled weighted
HDBSCAN, 1-NN noise reassignment and backfill through the `nn1` kernel,
full-density boundary refinement), coloured with jet.  Writes
``predictions.npz``, ``masks/mask_%04d.png`` and ``pca/pca_%04d.png``.  Depth
PNGs, GLB export and evaluation against ground truth are not part of this
port yet.

Usage:
    python -m iggt_official_tpu_torch.app.demo --target_dir <scene> \
        --save_dir out [--model_path weights.pt] [--preset large] \
        [--exact_clustering] [--image_size 504 336] [--device cuda]

Weights are random (from a seed) unless ``--model_path`` names a state dict
saved from this package's model (`torch.save(model.state_dict(), path)`),
whose names are the reference checkpoint's.
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
from iggt_official_tpu_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from iggt_official_tpu_torch.geometry.projection import unproject_depth_map_to_point_map
from iggt_official_tpu_torch.models.vggt import IGGT, build_model
from iggt_official_tpu_torch.ops.cluster import cluster_features_to_masks_mv, trace_stage
from iggt_official_tpu_torch.ops.knn import knn_smooth_features
from iggt_official_tpu_torch.ops.pca import normalize_and_pca
from iggt_official_tpu_torch.utils.device import resolve_device
from iggt_official_tpu_torch.utils.images import load_and_preprocess_images

logger = logging.getLogger(__name__)

CLUSTERING_PRESETS = {
    "small": CLUSTERING_SMALL,
    "medium": CLUSTERING_MEDIUM,
    "large": CLUSTERING_LARGE,
}


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
        self.cfg = model_cfg or ModelConfig()
        self.runtime = runtime or RuntimeConfig()
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = self._load_model(model_path, seed)

    def _load_model(self, model_path: Optional[str], seed: int) -> IGGT:
        model = build_model(self.cfg, self.device, seed=seed)
        if model_path is None:
            logger.warning("No checkpoint given: running with random weights (seed %d)", seed)
            return model
        state = torch.load(model_path, map_location=self.device, weights_only=True)
        model.load_state_dict(state)
        return model

    def process_scene(self, target_dir: str, save_dir: str) -> Dict[str, Any]:
        """Forward + post-process one scene; writes ``predictions.npz`` and
        the mask and PCA PNGs."""
        os.makedirs(save_dir, exist_ok=True)
        preds = self._post_process(self._run_inference(target_dir))
        preds = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in preds.items()}
        self._save_predictions(preds, save_dir)
        return preds

    @torch.inference_mode()
    def _run_inference(self, target_dir: str) -> Dict[str, Any]:
        W, H = self.runtime.image_size
        images = load_and_preprocess_images(
            scene_image_paths(target_dir), mode="resize", resize_target_size=(W, H))
        out = self.model(torch.from_numpy(images[None]).to(self.device))
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
    def _save_predictions(preds: Dict[str, np.ndarray], save_dir: str) -> None:
        """``predictions.npz`` plus one PNG per view of the coloured masks
        and of the PCA colours."""
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
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    runtime = RuntimeConfig(
        image_size=tuple(args.image_size),
        clustering=dataclasses.replace(CLUSTERING_PRESETS[args.preset],
                                       exact=args.exact_clustering))
    processor = IGGTProcessor(args.model_path, runtime=runtime, device=args.device)
    preds = processor.process_scene(args.target_dir, args.save_dir)
    logger.info("wrote %s (%d views)", os.path.join(args.save_dir, "predictions.npz"),
                preds["images"].shape[0])


if __name__ == "__main__":
    main()
