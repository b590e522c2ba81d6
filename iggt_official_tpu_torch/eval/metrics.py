"""Depth / pose / instance-mask metrics.

Copy of `iggt_official_tpu/eval/metrics.py` (numpy + scipy, host side), so
the port's demo evaluates against ground truth without the JAX package.

Behavioural parity: `iggt/metrics.py`:
- `valid_mean` / `thresh_inliers` / `m_rel_ae` (`metrics.py:82-165`)
- `DepthEvaluator` — median or least-squares scale alignment, clip to
  (0.1, 100), AbsRel x100, inlier@1.03 x100, density, MAE, RMSE,
  delta < 1.25^k (`metrics.py:259-409`)
- `PoseEvaluator` — per-frame translation L2 + rotation geodesic angle
  statistics (`metrics.py:430-540`)
- `evaluate_matched_instances` — Hungarian matching on the IoU matrix,
  matched mIoU / mAcc at IoU >= threshold (`metrics.py:22-80`)
- `SceneEvaluator` — per-scene orchestration + aggregation + JSON report
  (`metrics.py:541-720`)
"""

from __future__ import annotations

import json
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# shared helpers (`metrics.py:82-165`)


def valid_mean(arr, mask, axis=None, keepdims=np._NoValue):
    """Masked mean + validity flag (`metrics.py:82-106`)."""
    mask = mask.astype(arr.dtype) if mask.dtype == bool else mask
    num_valid = np.sum(mask, axis=axis, keepdims=keepdims)
    masked_sum = np.sum(arr * mask, axis=axis, keepdims=keepdims)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = masked_sum / num_valid
        is_valid = np.isfinite(mean)
        mean = np.nan_to_num(mean, nan=0, posinf=0, neginf=0)
    return mean, is_valid


def thresh_inliers(gt, pred, thresh, mask=None, output_scaling_factor=1.0):
    """Inlier ratio with max(gt/pred, pred/gt) < thresh (`metrics.py:108-136`)."""
    mask = (
        (gt > 0).astype(np.float32) * mask
        if mask is not None
        else (gt > 0).astype(np.float32)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_1 = np.nan_to_num(gt / pred, nan=thresh + 1, posinf=thresh + 1,
                              neginf=thresh + 1)
        rel_2 = np.nan_to_num(pred / gt, nan=0, posinf=0, neginf=0)
    max_rel = np.maximum(rel_1, rel_2)
    inliers = ((0 < max_rel) & (max_rel < thresh)).astype(np.float32)
    ratio, valid = valid_mean(inliers, mask)
    ratio = ratio * output_scaling_factor
    return ratio if valid else np.nan


def m_rel_ae(gt, pred, mask=None, output_scaling_factor=1.0):
    """Mean relative absolute error (`metrics.py:139-165`)."""
    mask = (
        (gt > 0).astype(np.float32) * mask
        if mask is not None
        else (gt > 0).astype(np.float32)
    )
    ae = np.abs(pred - gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_ae = np.nan_to_num(ae / gt, nan=0, posinf=0, neginf=0)
    mean, valid = valid_mean(rel_ae, mask)
    mean = mean * output_scaling_factor
    return mean if valid else np.nan


# ---------------------------------------------------------------------------
# instance-mask matching (`metrics.py:15-80`)


def pointwise_rel_ae(gt, pred, mask=None, output_scaling_factor=1.0):
    """Per-pixel relative absolute error |gt-pred|/gt, 0 where invalid
    (`iggt/metrics.py:150-175` semantics: gt<=0 excluded via the mask)."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    valid = gt > 0
    if mask is not None:
        valid = valid & (np.asarray(mask) > 0)
    rel = np.zeros_like(gt)
    np.divide(np.abs(gt - pred), gt, out=rel, where=valid)
    return rel * output_scaling_factor * valid


def sparsification(
    gt: np.ndarray,
    pred: np.ndarray,
    uncertainty: np.ndarray,
    mask: Optional[np.ndarray] = None,
    error_fct: Callable = m_rel_ae,
    steps: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparsification curve (`iggt/metrics.py:176-255`).

    Pixels are removed in order of decreasing ``uncertainty``; at each of
    ``steps`` removal fractions the remaining pixels' error (relative to
    the full-mask error) is recorded.  Returns (x, y): x the removal
    fractions linspace(0, 0.99, steps), y the interpolated error ratios
    (NaN when fewer than 2 finite samples).  Vectorized: sorts once and
    evaluates ``error_fct`` at the 1%% steps instead of per pixel.
    """
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    m = (gt > 0).astype(np.float64)
    if mask is not None:
        m = m * np.asarray(mask, np.float64)
    num_valid = int(m.astype(bool).sum())
    x = np.linspace(0, 0.99, steps)
    if num_valid == 0:
        return x, np.full(steps, np.nan)

    # most-uncertain first, invalid pixels pinned to the end
    # (`metrics.py:212-215` sorts (uncertainty - min + 1) * mask ascending
    # and walks it reversed)
    order = np.argsort(
        ((uncertainty - uncertainty.min() + 1) * m).reshape(-1)
    )[::-1]
    base_error = error_fct(gt=gt, pred=pred, mask=m)

    xs, ys = [], []
    cur = m.reshape(-1).copy()
    removed = 0
    for i in range(steps):
        target = int(num_valid / steps * i)
        while removed < target:
            cur[order[removed]] = 0
            removed += 1
        err = error_fct(gt=gt, pred=pred, mask=cur.reshape(m.shape))
        if np.isfinite(err):
            xs.append(removed / num_valid)
            ys.append(err / base_error)
    if len(xs) > 1:
        return x, np.interp(x, xs, ys)
    return x, np.full(steps, np.nan)


def calculate_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    inter = np.sum(np.logical_and(mask1, mask2))
    union = np.sum(np.logical_or(mask1, mask2))
    return inter / union if union > 0 else 0.0


def evaluate_matched_instances(
    gt_masks: List[np.ndarray],
    pred_masks: List[np.ndarray],
    iou_threshold: float = 0.5,
) -> Tuple[Dict[str, float], List[Tuple[int, int]]]:
    """Hungarian matching on IoU; matched mIoU / mAcc (`metrics.py:21-80`)."""
    from scipy.optimize import linear_sum_assignment

    if len(gt_masks) == 0 or len(pred_masks) == 0:
        return {"matched_miou": 0, "matched_macc": 0, "num_matches": 0}, []

    iou = np.zeros((len(gt_masks), len(pred_masks)))
    for i, g in enumerate(gt_masks):
        for j, p in enumerate(pred_masks):
            iou[i, j] = calculate_iou(g, p)

    gt_idx, pred_idx = linear_sum_assignment(1 - iou)
    matches, mious, maccs = [], [], []
    for gi, pi in zip(gt_idx, pred_idx):
        if iou[gi, pi] >= iou_threshold:
            matches.append((gi, pi))
            mious.append(iou[gi, pi])
            tp = np.sum(np.logical_and(gt_masks[gi], pred_masks[pi]))
            gt_pix = np.sum(gt_masks[gi])
            maccs.append(tp / gt_pix if gt_pix > 0 else 0)

    if not matches:
        return {"matched_miou": 0, "matched_macc": 0, "num_matches": 0}, []
    return (
        {
            "matched_miou": float(np.mean(mious)),
            "matched_macc": float(np.mean(maccs)),
            "num_matches": len(matches),
        },
        matches,
    )


def masks_from_label_map(label_map: np.ndarray, ignore: int = -1) -> List[np.ndarray]:
    """Split an integer label map into boolean per-instance masks."""
    return [
        label_map == lbl for lbl in np.unique(label_map) if lbl != ignore
    ]


# ---------------------------------------------------------------------------
# depth (`metrics.py:256-427`)


class DepthEvaluator:
    def __init__(
        self,
        alignment: str = "median",
        clip_pred_depth: Optional[Tuple[float, float]] = (0.1, 100.0),
        sparse_pred: bool = False,
    ):
        self.alignment = alignment
        self.clip_pred_depth = clip_pred_depth
        self.sparse_pred = sparse_pred

    def evaluate_depth(self, gt_depth, pred_depth) -> Dict[str, float]:
        gt_depth = np.asarray(gt_depth)
        pred_depth = np.asarray(pred_depth)
        if gt_depth.ndim == 3 and gt_depth.shape[-1] == 1:
            gt_depth = gt_depth.squeeze(-1)
        if pred_depth.ndim == 3 and pred_depth.shape[-1] == 1:
            pred_depth = pred_depth.squeeze(-1)
        if gt_depth.shape != pred_depth.shape:
            pred_depth = _resize_nearest(pred_depth, gt_depth.shape)

        pred_mask = (
            pred_depth != 0 if self.sparse_pred
            else np.ones_like(pred_depth, bool)
        )
        gt_mask = gt_depth > 0
        valid = gt_mask & pred_mask
        if not valid.any():
            return self._empty()

        aligned, scale = self._align(gt_depth, pred_depth, valid)
        if self.clip_pred_depth is not None:
            aligned = np.clip(aligned, *self.clip_pred_depth) * pred_mask

        out = self._metrics(gt_depth, aligned, valid)
        out["scaling_factor"] = scale
        out["valid_pixels"] = int(np.sum(valid))
        out["total_pixels"] = int(gt_depth.size)
        out["valid_ratio"] = float(np.sum(valid) / gt_depth.size)
        return out

    def _align(self, gt, pred, mask):
        if self.alignment == "median":
            g, p = gt[mask], pred[mask]
            if len(g) and len(p):
                ratio = np.median(g) / np.median(p)
                if np.isfinite(ratio):
                    return pred * ratio, ratio
            return pred, 1.0
        if self.alignment == "least_squares":
            g, p = gt[mask].ravel(), pred[mask].ravel()
            if len(g) and len(p):
                scale = np.sum(g * p) / np.sum(p**2)
                if np.isfinite(scale) and scale > 0:
                    return pred * scale, scale
            return pred, 1.0
        return pred, 1.0

    def _metrics(self, gt, pred, mask) -> Dict[str, float]:
        eval_mask = (
            pred != 0 if self.sparse_pred else np.ones_like(pred, bool)
        ) & mask
        absrel = m_rel_ae(gt, pred, mask=eval_mask, output_scaling_factor=100.0)
        inliers = thresh_inliers(gt, pred, 1.03, mask=eval_mask,
                                 output_scaling_factor=100.0)
        density = np.sum(eval_mask) / eval_mask.size * 100

        g, p = gt[eval_mask], pred[eval_mask]
        if len(g):
            mae = float(np.mean(np.abs(g - p)))
            rmse = float(np.sqrt(np.mean((g - p) ** 2)))
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.maximum(g / p, p / g)
                ratio = ratio[np.isfinite(ratio)]
            if len(ratio):
                d1 = float(np.mean(ratio < 1.25) * 100)
                d2 = float(np.mean(ratio < 1.25**2) * 100)
                d3 = float(np.mean(ratio < 1.25**3) * 100)
            else:
                d1 = d2 = d3 = np.nan
        else:
            mae = rmse = d1 = d2 = d3 = np.nan

        return {
            "absrel": absrel,
            "inliers103": inliers,
            "pred_depth_density": density,
            "mae": mae,
            "rmse": rmse,
            "delta_1": d1,
            "delta_2": d2,
            "delta_3": d3,
        }

    def _empty(self) -> Dict[str, float]:
        keys = ["absrel", "inliers103", "pred_depth_density", "mae", "rmse",
                "delta_1", "delta_2", "delta_3"]
        out = {k: np.nan for k in keys}
        out.update(scaling_factor=1.0, valid_pixels=0, total_pixels=0,
                   valid_ratio=0.0)
        return out


def _resize_nearest(arr: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize (skimage order=0 equivalent)."""
    H, W = shape
    ys = (np.arange(H) + 0.5) * arr.shape[0] / H - 0.5
    xs = (np.arange(W) + 0.5) * arr.shape[1] / W - 0.5
    ys = np.clip(np.round(ys).astype(int), 0, arr.shape[0] - 1)
    xs = np.clip(np.round(xs).astype(int), 0, arr.shape[1] - 1)
    return arr[ys][:, xs]


# ---------------------------------------------------------------------------
# pose (`metrics.py:429-540`)


class PoseEvaluator:
    def evaluate_poses(self, gt_poses, pred_poses) -> Dict[str, Any]:
        gt_poses = np.asarray(gt_poses)
        pred_poses = np.asarray(pred_poses)
        if gt_poses.shape != pred_poses.shape:
            logger.error("pose shape mismatch")
            return {}
        gt4 = self._to_4x4(gt_poses)
        pr4 = self._to_4x4(pred_poses)

        t_err = np.linalg.norm(gt4[:, :3, 3] - pr4[:, :3, 3], axis=-1)
        r_err = np.array(
            [self._rot_err(g[:3, :3], p[:3, :3]) for g, p in zip(gt4, pr4)]
        )
        stats = {}
        for name, err in [("translation_error", t_err), ("rotation_error", r_err)]:
            stats.update({
                f"{name}_mean": float(np.mean(err)),
                f"{name}_median": float(np.median(err)),
                f"{name}_std": float(np.std(err)),
                f"{name}_max": float(np.max(err)),
                f"{name}_min": float(np.min(err)),
            })
        stats["num_poses"] = len(gt4)
        stats["translation_errors"] = t_err
        stats["rotation_errors"] = r_err
        return stats

    @staticmethod
    def _to_4x4(poses: np.ndarray) -> np.ndarray:
        if poses.shape[-2:] == (4, 4):
            return poses
        out = np.tile(np.eye(4), (len(poses), 1, 1))
        out[:, :3, :4] = poses
        return out

    @staticmethod
    def _rot_err(R1: np.ndarray, R2: np.ndarray) -> float:
        """Geodesic angle in degrees."""
        cos = (np.trace(R1.T @ R2) - 1) / 2
        return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


# ---------------------------------------------------------------------------
# scene orchestration (`metrics.py:541-720`)


class SceneEvaluator:
    def __init__(
        self,
        depth_alignment: str = "median",
        depth_clip_range: Optional[Tuple[float, float]] = (0.1, 100.0),
    ):
        self.depth_evaluator = DepthEvaluator(
            alignment=depth_alignment, clip_pred_depth=depth_clip_range
        )
        self.pose_evaluator = PoseEvaluator()

    def evaluate_scene(self, gt_data: Dict, predictions: Dict) -> Dict[str, Any]:
        results: Dict[str, Any] = {
            "depth_metrics": {},
            "pose_metrics": {},
            "summary": {},
        }
        if "gt_depth" in gt_data and "depth" in predictions:
            frames = []
            for i in range(len(gt_data["gt_depth"])):
                m = self.depth_evaluator.evaluate_depth(
                    gt_data["gt_depth"][i], predictions["depth"][i]
                )
                m["frame_id"] = i
                frames.append(m)
            results["depth_metrics"] = self._aggregate_depth(frames)
            results["depth_metrics"]["per_frame"] = frames

        if "gt_extrinsic" in gt_data and "extrinsic" in predictions:
            results["pose_metrics"] = self.pose_evaluator.evaluate_poses(
                gt_data["gt_extrinsic"], predictions["extrinsic"]
            )

        if "gt_instance_masks" in gt_data and "instance_masks" in predictions:
            metrics, _ = evaluate_matched_instances(
                gt_data["gt_instance_masks"], predictions["instance_masks"]
            )
            results["instance_metrics"] = metrics

        results["summary"] = self._summary(results)
        return results

    @staticmethod
    def _aggregate_depth(frames: List[Dict]) -> Dict[str, float]:
        if not frames:
            return {}
        keys = ["absrel", "inliers103", "pred_depth_density", "mae", "rmse",
                "delta_1", "delta_2", "delta_3", "valid_ratio"]
        agg: Dict[str, float] = {}
        for k in keys:
            vals = [m[k] for m in frames if k in m and np.isfinite(m[k])]
            if vals:
                agg[f"{k}_mean"] = float(np.mean(vals))
                agg[f"{k}_median"] = float(np.median(vals))
                agg[f"{k}_std"] = float(np.std(vals))
                agg[f"{k}_min"] = float(np.min(vals))
                agg[f"{k}_max"] = float(np.max(vals))
        tv = sum(m["valid_pixels"] for m in frames)
        tp = sum(m["total_pixels"] for m in frames)
        agg["total_valid_pixels"] = tv
        agg["total_pixels"] = tp
        agg["overall_valid_ratio"] = tv / tp if tp else 0
        return agg

    @staticmethod
    def _summary(results: Dict) -> Dict[str, Any]:
        summary: Dict[str, Any] = {}
        dm = results.get("depth_metrics") or {}
        if dm:
            summary["depth"] = {
                "absrel": dm.get("absrel_mean", np.nan),
                "inliers103": dm.get("inliers103_mean", np.nan),
                "pred_depth_density": dm.get("pred_depth_density_mean", np.nan),
                "mae": dm.get("mae_mean", np.nan),
                "rmse": dm.get("rmse_mean", np.nan),
                "delta_1": dm.get("delta_1_mean", np.nan),
                "valid_ratio": dm.get("overall_valid_ratio", 0),
            }
        pm = results.get("pose_metrics") or {}
        if pm:
            summary["pose"] = {
                "translation_error": pm.get("translation_error_mean", np.nan),
                "rotation_error": pm.get("rotation_error_mean", np.nan),
                "num_poses": pm.get("num_poses", 0),
            }
        im = results.get("instance_metrics") or {}
        if im:
            summary["instance"] = dict(im)
        return summary

    def save_evaluation_report(self, results: Dict, save_path: str) -> None:
        def conv(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, np.floating):
                return float(o)
            if isinstance(o, np.integer):
                return int(o)
            if isinstance(o, dict):
                return {k: conv(v) for k, v in o.items()}
            if isinstance(o, list):
                return [conv(v) for v in o]
            return o

        with open(save_path, "w") as f:
            json.dump(conv(results), f, indent=2)

    def print_summary(self, results: Dict) -> None:
        print("\n" + "=" * 60)
        print("SCENE EVALUATION SUMMARY")
        print("=" * 60)
        s = results.get("summary", {})
        if "depth" in s:
            d = s["depth"]
            print("\nDEPTH METRICS:")
            print(f"  AbsRel:     {d['absrel']:.4f}%")
            print(f"  Inliers103: {d['inliers103']:.4f}%")
            print(f"  MAE:        {d['mae']:.4f}")
            print(f"  RMSE:       {d['rmse']:.4f}")
            print(f"  d<1.25:     {d['delta_1']:.4f}%")
        if "pose" in s:
            p = s["pose"]
            print("\nPOSE METRICS:")
            print(f"  Trans err:  {p['translation_error']:.4f}")
            print(f"  Rot err:    {p['rotation_error']:.4f} deg")
        if "instance" in s:
            i = s["instance"]
            print("\nINSTANCE METRICS:")
            print(f"  matched mIoU: {i['matched_miou']:.4f}")
            print(f"  matched mAcc: {i['matched_macc']:.4f}")
