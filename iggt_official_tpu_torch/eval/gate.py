"""Checkpoint-acceptance gate vs the reference demo's golden predictions.

Copy of `iggt_official_tpu/eval/gate.py` (numpy on the host).

BASELINE acceptance: depth AbsRel and instance-mask matched mIoU within 1%
of the reference PyTorch checkpoint.  The reference demo saves its full
prediction dict per scene as ``predictions.npz`` (`demo.py:611-615`); this
module compares our pipeline's predictions for the same scene directly
against that file — no GT needed — and emits the acceptance table.

The harness is weight-source-agnostic: point `app.batch_eval --model_path`
at a reference checkpoint and `--golden_root` at the directory of the
reference run's per-scene outputs.  tests/test_torch_batch_eval.py proves it
end to end with random-weight self-goldens.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# acceptance thresholds (BASELINE.json): "within 1% of the torch ckpt"
GATE_DEPTH_ABSREL = 0.01   # mean |ours - golden| / golden over valid px
GATE_MASK_MIOU = 0.99      # Hungarian matched mIoU, ours vs golden labels


def labels_to_masks(labels: np.ndarray) -> List[np.ndarray]:
    """(S, H, W) integer label volume -> per-instance binary masks.

    Label ids are arbitrary in both pipelines (cluster order differs), so
    comparisons always go through Hungarian matching on these sets.
    Noise (-1 / background 0 in colored-derived volumes) is excluded.
    """
    return [labels == i for i in np.unique(labels) if i >= 0]


def masks_from_colored(colored: np.ndarray) -> List[np.ndarray]:
    """Recover instance masks from a colored mask video (S, H, W, 3).

    The reference demo stores only the *colored* cluster masks in its
    prediction dict (`demo.py:398`, `predictions['features']`); each
    cluster gets a distinct colormap entry and noise is black, so unique
    non-black colors are the instances.
    """
    flat = colored.reshape(-1, colored.shape[-1])
    colors = np.unique(flat, axis=0)
    masks = []
    for c in colors:
        if not np.any(c):  # black = noise/background
            continue
        masks.append(np.all(colored == c, axis=-1))
    return masks


def _golden_masks(golden: Dict[str, np.ndarray]) -> Optional[List[np.ndarray]]:
    if "instance_masks" in golden:
        return labels_to_masks(np.asarray(golden["instance_masks"]))
    if "features" in golden:  # reference colored masks (S, H, W, 3)
        feats = np.asarray(golden["features"])
        if feats.ndim == 4 and feats.shape[-1] == 3:
            return masks_from_colored(feats)
    return None


def _depth_absrel(ours: np.ndarray, golden: np.ndarray) -> float:
    ours = np.asarray(ours, np.float64).reshape(-1)
    golden = np.asarray(golden, np.float64).reshape(-1)
    valid = golden > 1e-6
    if not valid.any():
        return float("nan")
    return float(np.mean(np.abs(ours[valid] - golden[valid]) / golden[valid]))


def compare_scene(
    preds: Dict[str, np.ndarray],
    golden: Dict[str, np.ndarray],
    iou_threshold: float = 0.5,
) -> Dict[str, Any]:
    """Per-scene acceptance comparison; every metric is ours-vs-golden."""
    from iggt_official_tpu_torch.eval.metrics import evaluate_matched_instances

    row: Dict[str, Any] = {}

    if "depth" in preds and "depth" in golden:
        ours_d = np.asarray(preds["depth"]).squeeze()
        gold_d = np.asarray(golden["depth"]).squeeze()
        if ours_d.shape != gold_d.shape:
            row["depth_error"] = (
                f"shape mismatch {ours_d.shape} vs {gold_d.shape}")
        else:
            row["depth_absrel"] = _depth_absrel(ours_d, gold_d)

    gold_masks = _golden_masks(golden)
    if gold_masks is not None and "instance_masks" in preds:
        our_masks = labels_to_masks(np.asarray(preds["instance_masks"]))
        stats, _ = evaluate_matched_instances(
            gold_masks, our_masks, iou_threshold=iou_threshold
        )
        row["mask_matched_miou"] = float(stats["matched_miou"])
        row["mask_num_matches"] = int(stats["num_matches"])
        row["mask_num_golden"] = len(gold_masks)

    if "extrinsic" in preds and "extrinsic" in golden:
        ours_e = np.asarray(preds["extrinsic"]).reshape(-1, 3, 4)
        gold_e = np.asarray(golden["extrinsic"]).reshape(-1, 3, 4)
        if ours_e.shape == gold_e.shape:
            r_rel = ours_e[:, :, :3] @ gold_e[:, :, :3].transpose(0, 2, 1)
            cos = np.clip((np.trace(r_rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
            row["pose_rot_deg"] = float(np.degrees(np.arccos(cos)).mean())
            t_scale = max(float(np.linalg.norm(gold_e[:, :, 3], axis=1).mean()),
                          1e-9)
            row["pose_trans_rel"] = float(
                np.linalg.norm(ours_e[:, :, 3] - gold_e[:, :, 3], axis=1).mean()
                / t_scale)

    row["pass"] = bool(
        row.get("depth_absrel", 0.0) <= GATE_DEPTH_ABSREL
        and row.get("mask_matched_miou", 1.0) >= GATE_MASK_MIOU
        and "depth_error" not in row
    )
    return row


def gate_report(rows: Dict[str, Dict[str, Any]]) -> Tuple[str, bool]:
    """Render the acceptance table; overall pass = every scene passes."""
    header = (f"{'scene':<16}{'AbsRel Δ':>10}{'mask mIoU':>11}"
              f"{'rot °':>8}{'trans':>8}  gate")
    lines = [header, "-" * len(header)]
    ok = True
    for name, r in sorted(rows.items()):
        absrel = r.get("depth_absrel")
        miou = r.get("mask_matched_miou")
        lines.append(
            f"{name:<16}"
            + (f"{absrel:>10.4f}" if absrel is not None else f"{'n/a':>10}")
            + (f"{miou:>11.4f}" if miou is not None else f"{'n/a':>11}")
            + f"{r.get('pose_rot_deg', float('nan')):>8.3f}"
            + f"{r.get('pose_trans_rel', float('nan')):>8.4f}"
            + ("  PASS" if r["pass"] else "  FAIL")
        )
        ok &= r["pass"]
    lines.append(
        f"thresholds: depth AbsRel <= {GATE_DEPTH_ABSREL}, "
        f"matched mIoU >= {GATE_MASK_MIOU}"
    )
    return "\n".join(lines), ok


def run_gate(
    scene_results: Dict[str, Dict[str, np.ndarray]],
    golden_root: str,
    save_path: Optional[str] = None,
) -> Tuple[str, bool]:
    """Compare many scenes' predictions against golden_root/<scene>/predictions.npz."""
    rows: Dict[str, Dict[str, Any]] = {}
    for name, preds in scene_results.items():
        gpath = os.path.join(golden_root, name, "predictions.npz")
        if not os.path.exists(gpath):
            rows[name] = {"pass": False, "depth_error": "no golden npz"}
            continue
        with np.load(gpath, allow_pickle=False) as g:
            golden = {k: g[k] for k in g.files}
        rows[name] = compare_scene(preds, golden)
    table, ok = gate_report(rows)
    if save_path:
        with open(save_path, "w") as f:
            json.dump({"scenes": rows, "pass": ok}, f, indent=2, default=float)
    return table, ok
