"""Visual-odometry trajectory evaluation (ATE / RPE), first-party.

Copy of `iggt_official_tpu/eval/trajectory.py` (numpy on the host), its
quaternions through the port's `geometry/rotation.py` in fp32 as the JAX
package's are.  Behavioural parity: `iggt/utils/vo_eval.py:163-248` (`eval_metrics`), which
wraps the external `evo` package: APE-translation RMSE with Sim(3)
(scale-corrected) Umeyama alignment, RPE-translation and RPE-rotation over
consecutive frames, plus TUM-format trajectory IO (`vo_eval.py:115-160`).
Implemented directly (Umeyama 1991 closed form; no evo dependency).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    src, dst: (N, 3).  Returns (s, R (3,3), t (3,)).
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _rot_angle_deg(R: np.ndarray) -> np.ndarray:
    cos = (np.trace(R, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def ate_rmse(
    gt_xyz: np.ndarray, pred_xyz: np.ndarray, correct_scale: bool = True
) -> Tuple[float, Tuple[float, np.ndarray, np.ndarray]]:
    """Absolute trajectory error RMSE after Sim(3)/SE(3) alignment."""
    s, R, t = umeyama_alignment(pred_xyz, gt_xyz, with_scale=correct_scale)
    aligned = (s * (R @ pred_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return float(np.sqrt(np.mean(err**2))), (s, R, t)


def rpe(
    gt_se3: np.ndarray, pred_se3: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over `delta`-frame steps.

    gt_se3/pred_se3: (N, 4, 4) camera-to-world poses.
    Returns (RPE-trans RMSE [m], RPE-rot RMSE [deg]).
    """
    def rel(poses):
        a = np.linalg.inv(poses[:-delta])
        return a @ poses[delta:]

    rg = rel(gt_se3)
    rp = rel(pred_se3)
    err = np.linalg.inv(rg) @ rp
    t_err = np.linalg.norm(err[:, :3, 3], axis=1)
    r_err = _rot_angle_deg(err[:, :3, :3])
    return float(np.sqrt(np.mean(t_err**2))), float(np.sqrt(np.mean(r_err**2)))


def eval_metrics(
    pred_se3: np.ndarray,
    gt_se3: np.ndarray,
    correct_scale: bool = True,
) -> Dict[str, float]:
    """ATE + RPE summary, mirroring `vo_eval.py:163-248`'s outputs."""
    ate, _ = ate_rmse(gt_se3[:, :3, 3], pred_se3[:, :3, 3],
                      correct_scale=correct_scale)
    rpe_t, rpe_r = rpe(gt_se3, pred_se3)
    return {"ate": ate, "rpe_trans": rpe_t, "rpe_rot": rpe_r}


def save_trajectory_tum_format(
    poses_se3: np.ndarray,
    timestamps: Optional[np.ndarray],
    path: str,
) -> None:
    """TUM format: `ts tx ty tz qx qy qz qw` (`vo_eval.py:115-139`)."""
    import torch

    from iggt_official_tpu_torch.geometry.rotation import mat_to_quat

    if timestamps is None:
        timestamps = np.arange(len(poses_se3), dtype=np.float64)
    quats = mat_to_quat(torch.from_numpy(np.asarray(poses_se3[:, :3, :3], np.float32))).numpy()
    # our codec is xyzw real-last already (`rotation.py` parity notes)
    with open(path, "w") as f:
        for ts, pose, q in zip(timestamps, poses_se3, quats):
            tx, ty, tz = pose[:3, 3]
            f.write(
                f"{ts} {tx} {ty} {tz} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )


def load_trajectory_tum_format(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (poses (N, 4, 4), timestamps (N,))."""
    import torch

    from iggt_official_tpu_torch.geometry.rotation import quat_to_mat

    rows = np.loadtxt(path)
    rows = np.atleast_2d(rows)
    ts = rows[:, 0]
    t = rows[:, 1:4]
    q = rows[:, 4:8]
    R = quat_to_mat(torch.from_numpy(q.astype(np.float32))).numpy()
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return poses, ts


def sintel_cam_read(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel `.cam` file -> (intrinsic M (3,3), extrinsic N (3,4) w2c)
    (`vo_eval.py:22-42`): float32 magic tag 202021.25, then 9 float64
    intrinsics and 12 float64 extrinsics."""
    TAG_FLOAT = 202021.25
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, (
            f"cam_read: wrong tag (should be {TAG_FLOAT}, is {check})"
        )
        M = np.fromfile(f, dtype="float64", count=9).reshape(3, 3)
        N = np.fromfile(f, dtype="float64", count=12).reshape(3, 4)
    return M, N


def load_sintel_traj(cam_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Directory of Sintel `.cam` files -> (poses c2w (N, 4, 4),
    timestamps (N,)) (`vo_eval.py:74-101`): extrinsics are w2c and get
    inverted; positions are mean-centred like the reference."""
    import os

    names = sorted(n for n in os.listdir(cam_dir) if n.endswith(".cam"))
    assert names, f"no .cam files under {cam_dir}"
    tstamps = np.array(
        [float(n[:-4].split("_")[-1]) for n in names], np.float64
    )
    poses = []
    for n in names:
        _, N = sintel_cam_read(os.path.join(cam_dir, n))
        w2c = np.concatenate([N, [[0, 0, 0, 1]]], 0)
        poses.append(np.linalg.inv(w2c))
    poses = np.stack(poses)
    poses[:, :3, 3] -= poses[:, :3, 3].mean(0, keepdims=True)
    return poses, tstamps


def load_replica_traj(gt_file: str) -> Tuple[np.ndarray, np.ndarray]:
    """Replica `traj.txt`: one row-major 3x4 or 4x4 c2w pose per line
    (`vo_eval.py:45-72`) -> (poses (N, 4, 4), timestamps = frame index)."""
    rows = np.loadtxt(gt_file)
    rows = np.atleast_2d(rows)
    assert rows.shape[1] in (12, 16), rows.shape
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows[:, :12].reshape(-1, 3, 4)
    return poses, np.arange(len(rows), dtype=np.float64)


def load_traj(
    gt_traj_file: str,
    traj_format: str = "sintel",
    skip: int = 0,
    stride: int = 1,
    num_frames: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unified GT loader (`vo_eval.py:104-127`) -> (poses c2w (N, 4, 4),
    timestamps (N,)).  Formats: sintel (`.cam` dir), replica (traj txt),
    tum / tartanair (TUM `ts tx ty tz qx qy qz qw` rows)."""
    if traj_format == "replica":
        poses, ts = load_replica_traj(gt_traj_file)
    elif traj_format == "sintel":
        poses, ts = load_sintel_traj(gt_traj_file)
    elif traj_format in ("tum", "tartanair"):
        poses, ts = load_trajectory_tum_format(gt_traj_file)
    else:
        raise NotImplementedError(traj_format)
    poses = poses[skip::stride]
    ts = ts[skip::stride]
    if num_frames is not None:
        poses = poses[:num_frames]
        ts = ts[:num_frames]
    return poses, ts


def load_timestamps(time_file: str, traj_format: str = "tum"):
    """TUM/TartanAir timestamp sidecar files (`vo_eval.py:143-151`)."""
    if traj_format in ("tum", "tartanair"):
        with open(time_file) as f:
            return [
                float(x.split(" ")[0])
                for x in f.readlines()
                if not x.startswith("#")
            ]
    return None


def update_timestamps(
    gt_file: str, traj_format: str, skip: int = 0, stride: int = 1
):
    """Timestamps from the rgb.txt / times.txt next to the GT file
    (`vo_eval.py:130-141`)."""
    if traj_format == "tum":
        ts = load_timestamps(
            gt_file.replace("groundtruth.txt", "rgb.txt"), traj_format
        )
    elif traj_format == "tartanair":
        ts = load_timestamps(
            gt_file.replace("gt_pose.txt", "times.txt"), traj_format
        )
    else:
        return None
    return None if ts is None else ts[skip::stride]


def plot_trajectory(
    pred_se3: np.ndarray,
    gt_se3: Optional[np.ndarray] = None,
    title: str = "",
    filename: str = "traj",
    align: bool = True,
    correct_scale: bool = True,
) -> str:
    """Save a 2D trajectory comparison plot (`vo_eval.py:255-284`).

    The plot plane follows evo's best_plotmode (`vo_eval.py:250-253`): the
    two highest-variance position axes of the GT (or prediction) are drawn;
    the prediction is optionally Sim(3)/SE(3)-aligned to GT first.  Returns
    the written path `{filename}_traj_error.png`.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred_xyz = np.asarray(pred_se3)[:, :3, 3]
    gt_xyz = np.asarray(gt_se3)[:, :3, 3] if gt_se3 is not None else None

    if gt_xyz is not None and align:
        s, R, t = umeyama_alignment(pred_xyz, gt_xyz, with_scale=correct_scale)
        pred_xyz = s * pred_xyz @ R.T + t

    basis = gt_xyz if gt_xyz is not None else pred_xyz
    _, i1, i2 = np.argsort(np.var(basis, axis=0))
    ax_x, ax_y = int(i2), int(i1)
    names = "xyz"

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_title(title)
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, ax_x], gt_xyz[:, ax_y], "--", color="gray",
                label="Ground Truth")
    ax.plot(pred_xyz[:, ax_x], pred_xyz[:, ax_y], "-", color="blue",
            label="Predicted")
    ax.set_xlabel(f"{names[ax_x]} (m)")
    ax.set_ylabel(f"{names[ax_y]} (m)")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    out = f"{filename}_traj_error.png"
    fig.savefig(out, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out
