"""Benchmark-grade depth + relative-pose evaluation.

Copy of `iggt_official_tpu/eval/benchmark.py` (numpy + scipy on the host),
its rotations through the port's `geometry/rotation.py` in fp32 as the JAX
package's are.  Behavioural parity: `visual_util.py:510-950`:
- `depth_evaluation` (`:577-772`): masked (gt in (0, max_depth)) metrics
  with selectable alignment — median scale, least-squares scale+shift
  (lstsq), L1 scale+shift (lad, Nelder-Mead; lad2, gradient descent),
  Weiszfeld scale-only, and a disparity-space option; metrics AbsRel,
  SqRel, RMSE, LogRMSE, delta<1.25^k, plus the relative-error parity map.
- `cameras_evaluation` (`:773-792`): all-pairs relative pose errors ->
  RRA/RTA at 5 and 2 degrees (the reference's "Racc_3" names bind 2-degree
  thresholds, `:788-789`), and `calculate_auc` (`:933-950`) for AUC@30.

All numpy; the quaternion-based rotation-angle formula matches the
reference exactly (arccos(1 - 2*(1 - <q1,q2>^2))).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from iggt_official_tpu_torch.eval.metrics import PoseEvaluator  # noqa: F401  (re-export site)


def _torch_median(x: np.ndarray) -> float:
    """torch.median semantics: lower middle element for even counts."""
    v = np.sort(np.asarray(x).ravel())
    return float(v[(len(v) - 1) // 2])


def depth2disparity(depth: np.ndarray) -> np.ndarray:
    disp = np.zeros_like(depth)
    pos = depth > 0
    disp[pos] = 1.0 / depth[pos]
    return disp


def lstsq_scale_shift(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    A = np.stack([pred, np.ones_like(pred)], axis=1)
    sol, *_ = np.linalg.lstsq(A, gt[:, None], rcond=None)
    return float(sol[0]), float(sol[1])


def lad_scale_shift(
    pred: np.ndarray, gt: np.ndarray, s_init: float = 1.0, t_init: float = 0.0
) -> Tuple[float, float]:
    """L1 scale+shift via scipy minimize (`visual_util.py:522-539`)."""
    from scipy.optimize import minimize

    def loss(params):
        s, t = params
        return np.sum(np.abs(s * pred + t - gt))

    res = minimize(loss, [s_init, t_init])
    return float(res.x[0]), float(res.x[1])


def lad2_scale_shift(
    pred: np.ndarray,
    gt: np.ndarray,
    s_init: float = 1.0,
    t_init: float = 0.0,
    lr: float = 1e-4,
    max_iters: int = 1000,
    tol: float = 1e-6,
) -> Tuple[float, float]:
    """Adam-optimized L1 scale+shift (`visual_util.py:541-575`), as a small
    numpy Adam loop on the subgradient."""
    s, t = float(s_init), float(t_init)
    m = np.zeros(2)
    v = np.zeros(2)
    b1, b2, eps = 0.9, 0.999, 1e-8
    prev = None
    for i in range(1, max_iters + 1):
        r = s * pred + t - gt
        loss = np.sum(np.abs(r))
        sign = np.sign(r)
        g = np.array([np.sum(sign * pred), np.sum(sign)])
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1**i)
        vh = v / (1 - b2**i)
        upd = lr * mh / (np.sqrt(vh) + eps)
        s, t = s - upd[0], t - upd[1]
        if prev is not None and abs(prev - loss) < tol:
            break
        prev = loss
    return s, t


def weiszfeld_scale(pred: np.ndarray, gt: np.ndarray, iters: int = 10) -> float:
    """Scale-only IRLS (`visual_util.py:663-690`)."""
    s = np.nanmean(gt) / np.nanmean(pred)
    for _ in range(iters):
        w = 1.0 / (np.abs(s * pred - gt) + 1e-8)
        s = np.sum(w * pred * gt) / np.sum(w * pred**2)
    return float(max(s, 1e-3))


def depth_evaluation(
    predicted_depth: np.ndarray,
    ground_truth_depth: np.ndarray,
    max_depth: Optional[float] = 80,
    custom_mask: Optional[np.ndarray] = None,
    post_clip_min: Optional[float] = None,
    post_clip_max: Optional[float] = None,
    pre_clip_min: Optional[float] = None,
    pre_clip_max: Optional[float] = None,
    align_with_lstsq: bool = False,
    align_with_lad: bool = False,
    align_with_lad2: bool = False,
    align_with_scale: bool = False,
    disp_input: bool = False,
    lr: float = 1e-4,
    max_iters: int = 1000,
) -> Tuple[Dict[str, float], np.ndarray]:
    """Returns (metrics dict, relative-error parity map)."""
    pred0 = np.asarray(predicted_depth, np.float64).squeeze()
    gt0 = np.asarray(ground_truth_depth, np.float64).squeeze()
    if pred0.ndim == 3:
        w = pred0.shape[-1]
        pred0 = pred0.reshape(-1, w)
        gt0 = gt0.reshape(-1, w)
        if custom_mask is not None:
            custom_mask = np.asarray(custom_mask).reshape(-1, w)

    mask = (gt0 > 0) & (gt0 < max_depth) if max_depth is not None else gt0 > 0
    pred = pred0[mask].copy()
    gt = gt0[mask].copy()

    if pre_clip_min is not None:
        pred = np.maximum(pred, pre_clip_min)
    if pre_clip_max is not None:
        pred = np.minimum(pred, pre_clip_max)

    real_gt = gt.copy()
    if disp_input:
        gt = 1.0 / (gt + 1e-8)

    s = t = None
    scale_factor = None
    if align_with_lstsq:
        s, t = lstsq_scale_shift(pred, gt)
        pred = s * pred + t
    elif align_with_lad:
        s, t = lad_scale_shift(
            pred, gt, s_init=_torch_median(gt) / _torch_median(pred)
        )
        pred = s * pred + t
    elif align_with_lad2:
        s, t = lad2_scale_shift(
            pred, gt, s_init=_torch_median(gt) / _torch_median(pred),
            lr=lr, max_iters=max_iters,
        )
        pred = s * pred + t
    elif align_with_scale:
        s = weiszfeld_scale(pred, gt)
        pred = s * pred
    else:
        scale_factor = _torch_median(gt) / _torch_median(pred)
        pred = pred * scale_factor

    if disp_input:
        gt = real_gt
        pred = depth2disparity(pred)

    if post_clip_min is not None:
        pred = np.maximum(pred, post_clip_min)
    if post_clip_max is not None:
        pred = np.minimum(pred, post_clip_max)

    if custom_mask is not None:
        inner = np.asarray(custom_mask)[mask]
        pred = pred[inner]
        gt = gt[inner]

    n_valid = len(gt)
    if n_valid == 0:
        zeros = dict.fromkeys(
            ["Abs Rel", "Sq Rel", "RMSE", "Log RMSE", "δ < 1.25",
             "δ < 1.25^2", "δ < 1.25^3"], 0.0)
        zeros["valid_pixels"] = 0
        return zeros, np.zeros_like(gt0)

    abs_rel = float(np.mean(np.abs(pred - gt) / gt))
    sq_rel = float(np.mean((pred - gt) ** 2 / gt))
    rmse = float(np.sqrt(np.mean((pred - gt) ** 2)))
    predc = np.maximum(pred, 1e-5)
    log_rmse = float(np.sqrt(np.mean((np.log(predc) - np.log(gt)) ** 2)))
    ratio = np.maximum(predc / gt, gt / predc)
    d1 = float(np.mean(ratio < 1.25))
    d2 = float(np.mean(ratio < 1.25**2))
    d3 = float(np.mean(ratio < 1.25**3))

    # parity map over the original extent (`visual_util.py:731-748`)
    if s is not None and t is not None:
        aligned_full = pred0 * s + t
    elif s is not None:
        aligned_full = pred0 * s
    else:
        aligned_full = pred0 * scale_factor
    if disp_input:
        aligned_full = depth2disparity(aligned_full)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_map = np.abs(aligned_full - gt0) / gt0
    parity = np.where(mask, rel_map, 0.0)

    return (
        {
            "Abs Rel": abs_rel,
            "Sq Rel": sq_rel,
            "RMSE": rmse,
            "Log RMSE": log_rmse,
            "δ < 1.25": d1,
            "δ < 1.25^2": d2,
            "δ < 1.25^3": d3,
            "valid_pixels": n_valid,
        },
        parity,
    )


# ---------------------------------------------------------------------------
# relative pose (`visual_util.py:773-950`)


def _to_se3(poses: np.ndarray) -> np.ndarray:
    if poses.shape[-2:] == (4, 4):
        return poses
    out = np.tile(np.eye(4), (len(poses), 1, 1))
    out[:, :3, :4] = poses
    return out


def _inv_se3(se3: np.ndarray) -> np.ndarray:
    R = se3[:, :3, :3]
    t = se3[:, :3, 3]
    out = np.tile(np.eye(4), (len(se3), 1, 1))
    out[:, :3, :3] = np.swapaxes(R, 1, 2)
    out[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
    return out


def build_pair_index(N: int) -> Tuple[np.ndarray, np.ndarray]:
    i1, i2 = np.triu_indices(N, k=1)
    return i1, i2


def _mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    import torch

    from iggt_official_tpu_torch.geometry.rotation import mat_to_quat

    return mat_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()


def rotation_angle(rot_gt: np.ndarray, rot_pred: np.ndarray,
                   eps: float = 1e-15) -> np.ndarray:
    q_pred = _mat_to_quat_np(rot_pred)
    q_gt = _mat_to_quat_np(rot_gt)
    loss_q = np.maximum(1 - np.sum(q_pred * q_gt, axis=1) ** 2, eps)
    return np.degrees(np.arccos(np.clip(1 - 2 * loss_q, -1.0, 1.0)))


def translation_angle(t_gt: np.ndarray, t_pred: np.ndarray,
                      eps: float = 1e-15, ambiguity: bool = True) -> np.ndarray:
    tn = t_pred / (np.linalg.norm(t_pred, axis=1, keepdims=True) + eps)
    gn = t_gt / (np.linalg.norm(t_gt, axis=1, keepdims=True) + eps)
    loss_t = np.maximum(1.0 - np.sum(tn * gn, axis=1) ** 2, eps)
    err = np.degrees(np.arccos(np.sqrt(np.clip(1 - loss_t, 0.0, 1.0))))
    err = np.nan_to_num(err, nan=1e6, posinf=1e6)
    if ambiguity:
        err = np.minimum(err, np.abs(180 - err))
    return err


def se3_to_relative_pose_error(
    pred_se3: np.ndarray, gt_se3: np.ndarray, num_frames: int
) -> Tuple[np.ndarray, np.ndarray]:
    i1, i2 = build_pair_index(num_frames)
    rel_gt = _inv_se3(gt_se3[i1]) @ gt_se3[i2]
    rel_pred = _inv_se3(pred_se3[i1]) @ pred_se3[i2]
    r_err = rotation_angle(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_err = translation_angle(rel_gt[:, :3, 3], rel_pred[:, :3, 3])
    return r_err, t_err


def cameras_evaluation(
    gt_extrinsic: np.ndarray, pred_extrinsic: np.ndarray, num_frames: int
) -> Tuple[float, float, float, float, np.ndarray, np.ndarray]:
    """RRA/RTA at 5 deg and 2 deg + raw per-pair errors
    (`visual_util.py:773-792`)."""
    gt_se3 = _to_se3(np.asarray(gt_extrinsic))
    pred_se3 = _to_se3(np.asarray(pred_extrinsic))
    r_err, t_err = se3_to_relative_pose_error(pred_se3, gt_se3, num_frames)
    racc5 = float(np.mean(r_err < 5))
    tacc5 = float(np.mean(t_err < 5))
    racc2 = float(np.mean(r_err < 2))
    tacc2 = float(np.mean(t_err < 2))
    return racc5, tacc5, racc2, tacc2, r_err, t_err


def calculate_auc(
    r_error: np.ndarray, t_error: np.ndarray, max_threshold: int = 30
) -> float:
    """AUC of the max(r, t) error recall curve (`visual_util.py:933-950`)."""
    max_errors = np.maximum(r_error, t_error)
    bins = np.arange(max_threshold + 1)
    histogram, _ = np.histogram(max_errors, bins=bins)
    normalized = histogram.astype(float) / len(max_errors)
    return float(np.mean(np.cumsum(normalized)))
