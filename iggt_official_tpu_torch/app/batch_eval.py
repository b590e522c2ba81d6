"""Batch scene evaluation: the whole pipeline over many scene dirs
(counterpart of `iggt_official_tpu/app/batch_eval.py`).

Every scene under --scenes_root goes through inference, clustering / kNN /
PCA post-processing and export; the per-scene evaluation reports (where
there is ground truth) are aggregated into `summary.json` with the mean
depth / pose metrics and the throughput (views/s, post-processing
included).  With --gate every scene's predictions are held to
--golden_root/<scene>/predictions.npz (`eval/gate.py`) and a failing scene
exits 1.

One scene is prefetched: a worker thread loads scene i+1's ground truth
and runs its forward while scene i post-processes and exports on the
caller's thread (the reference runs scenes strictly in turn).  Only the
worker runs forwards and only the caller post-processes, so no module runs
on two threads at once; both enqueue on the device's default stream.

    python -m iggt_official_tpu_torch.app.batch_eval \
        --scenes_root scenes --save_dir out [--gate --golden_root ref] [--device cpu]

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def aggregate_summaries(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean of each finite depth / pose metric over the scenes' summaries."""
    depth_keys = ["absrel", "inliers103", "mae", "rmse", "delta_1"]
    pose_keys = ["translation_error", "rotation_error"]
    depth_vals = {k: [] for k in depth_keys}
    pose_vals = {k: [] for k in pose_keys}
    for s in summaries:
        for k in depth_keys:
            v = s.get("depth", {}).get(k)
            if v is not None and np.isfinite(v):
                depth_vals[k].append(v)
        for k in pose_keys:
            v = s.get("pose", {}).get(k)
            if v is not None and np.isfinite(v):
                pose_vals[k].append(v)
    return {"depth": {k: float(np.mean(v)) for k, v in depth_vals.items() if v},
            "pose": {k: float(np.mean(v)) for k, v in pose_vals.items() if v}}


def list_scenes(scenes_root: str) -> List[str]:
    """The directories under ``scenes_root`` that hold an images/ dir, sorted."""
    scene_dirs = sorted(d for d in glob.glob(os.path.join(scenes_root, "*"))
                        if os.path.isdir(os.path.join(d, "images")))
    if not scene_dirs:
        raise FileNotFoundError(f"no scenes with images/ under {scenes_root}")
    return scene_dirs


def run_scenes(processor, scene_dirs: Sequence[str], save_dir: str,
               keep_predictions: bool = False
               ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, np.ndarray]]]:
    """Every scene through ``processor`` (an `app.demo.IGGTProcessor`), one
    scene prefetched on a worker thread, each written to save_dir/<scene>;
    then ``summary.json`` in ``save_dir``.  Returns (the summary, each
    scene's predictions when ``keep_predictions``, else {})."""
    summaries: List[Dict] = []
    kept: Dict[str, Dict[str, np.ndarray]] = {}
    total_views = 0
    t0 = time.time()

    def fetch(scene):
        return processor._load_gt_data(scene), processor._run_inference(scene)

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fetch, scene_dirs[0])
        for i, scene in enumerate(scene_dirs):
            name = os.path.basename(scene.rstrip(os.sep))
            logger.info("processing scene %s", name)
            gt_data, preds = fut.result()
            if i + 1 < len(scene_dirs):
                fut = ex.submit(fetch, scene_dirs[i + 1])
            results = processor.process_scene(scene, os.path.join(save_dir, name),
                                              preds=preds, gt_data=gt_data)
            total_views += results["predictions"]["depth"].shape[0]
            if keep_predictions:
                kept[name] = results["predictions"]
            if "evaluation" in results:
                summaries.append(results["evaluation"]["summary"])
    elapsed = time.time() - t0
    summary = {
        "num_scenes": len(scene_dirs),
        "num_views": total_views,
        "total_seconds": elapsed,
        "views_per_sec_end_to_end": total_views / elapsed,
        "metrics": aggregate_summaries(summaries),
    }
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary, kept


def main(argv: Optional[Sequence[str]] = None) -> None:
    from iggt_official_tpu_torch.app.demo import CLUSTERING_PRESETS, IGGTProcessor
    from iggt_official_tpu_torch.config import RuntimeConfig

    parser = argparse.ArgumentParser(description="IGGT batch evaluation (PyTorch / CUDA)")
    parser.add_argument("--scenes_root", required=True,
                        help="directory of scene dirs (each with images/)")
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--preset", default="large", choices=list(CLUSTERING_PRESETS))
    parser.add_argument("--image_size", type=int, nargs=2, default=(504, 336),
                        metavar=("W", "H"))
    parser.add_argument("--exact_clustering", action="store_true",
                        help="full-density HDBSCAN (the reference algorithm "
                             "verbatim; slow, for fidelity evaluation runs)")
    parser.add_argument("--ckpt", default=None,
                        help="reference .pth checkpoint (alias of --model_path)")
    parser.add_argument("--gate", action="store_true",
                        help="acceptance gate: compare every scene against "
                             "--golden_root/<scene>/predictions.npz (the reference "
                             "demo's saved outputs); exit 1 if any scene is "
                             "outside the 1%% window")
    parser.add_argument("--golden_root", default=None,
                        help="directory of the reference run's per-scene output "
                             "dirs (required with --gate)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.ckpt:
        args.model_path = args.ckpt
    if args.gate and not args.golden_root:
        parser.error("--gate requires --golden_root")

    logging.basicConfig(level=logging.INFO)
    runtime = RuntimeConfig(
        image_size=tuple(args.image_size),
        clustering=dataclasses.replace(CLUSTERING_PRESETS[args.preset],
                                       exact=args.exact_clustering))
    processor = IGGTProcessor(args.model_path, runtime=runtime, device=args.device)
    summary, gate_preds = run_scenes(processor, list_scenes(args.scenes_root), args.save_dir,
                                     keep_predictions=args.gate)
    print(json.dumps(summary, indent=2))
    if args.gate:
        from iggt_official_tpu_torch.eval.gate import run_gate

        table, ok = run_gate(gate_preds, args.golden_root,
                             save_path=os.path.join(args.save_dir, "gate.json"))
        print(table)
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
