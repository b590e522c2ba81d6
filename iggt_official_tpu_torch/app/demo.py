"""Scene processing: images -> depth / points / poses / part features.

Counterpart of `iggt_official_tpu/app/demo.py` (`IGGTProcessor`) up to pose
decode and unprojection: load and resize the scene's images, one forward of
the IGGT model (bf16 trunk through the hand-written attention kernels, fp32
heads), decode the poses, unproject the depth maps, and write
``predictions.npz``.  PCA colouring, kNN smoothing, clustering, depth PNGs
and GLB export are not part of this port yet.

Usage:
    python -m iggt_official_tpu_torch.app.demo --target_dir <scene> \
        --save_dir out [--model_path weights.pt] [--image_size 504 336] \
        [--device cuda]

Weights are random (from a seed) unless ``--model_path`` names a state dict
saved from this package's model (`torch.save(model.state_dict(), path)`),
whose names are the reference checkpoint's.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from iggt_official_tpu_torch.config import ModelConfig, RuntimeConfig
from iggt_official_tpu_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from iggt_official_tpu_torch.geometry.projection import unproject_depth_map_to_point_map
from iggt_official_tpu_torch.models.vggt import IGGT, build_model
from iggt_official_tpu_torch.utils.device import resolve_device
from iggt_official_tpu_torch.utils.images import load_and_preprocess_images

logger = logging.getLogger(__name__)


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
        """Forward + post-process one scene; writes ``predictions.npz``."""
        os.makedirs(save_dir, exist_ok=True)
        preds = self._post_process(self._run_inference(target_dir))
        preds = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                 for k, v in preds.items()}
        np.savez(os.path.join(save_dir, "predictions.npz"), **preds)
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
    def _post_process(self, preds: Dict[str, Any]) -> Dict[str, Any]:
        """Decode poses and unproject the depth maps (batch dim dropped)."""
        S, H, W = preds["images"].shape[:3]
        extri, intri = pose_encoding_to_extri_intri(preds["pose_enc"], (H, W))
        preds["extrinsic"] = extri[0]
        preds["intrinsic"] = intri[0]
        for k in ("depth", "depth_conf", "world_points", "world_points_conf", "part_feat"):
            if k in preds:
                preds[k] = preds[k][0]
        preds["world_points_from_depth"] = unproject_depth_map_to_point_map(
            preds["depth"], preds["extrinsic"], preds["intrinsic"])
        return preds


def main() -> None:
    parser = argparse.ArgumentParser(description="IGGT scene forward (PyTorch / CUDA)")
    parser.add_argument("--target_dir", required=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--image_size", type=int, nargs=2, default=(504, 336),
                        metavar=("W", "H"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    processor = IGGTProcessor(args.model_path,
                              runtime=RuntimeConfig(image_size=tuple(args.image_size)),
                              device=args.device)
    preds = processor.process_scene(args.target_dir, args.save_dir)
    logger.info("wrote %s (%d views)", os.path.join(args.save_dir, "predictions.npz"),
                preds["images"].shape[0])


if __name__ == "__main__":
    main()
