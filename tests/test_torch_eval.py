"""The port's geometry encoders and evaluation modules (`geometry/`,
`eval/benchmark.py`, `eval/trajectory.py`, `eval/gate.py`) against the JAX
package's, on the CPU.

Inputs come from numpy seeds.  Tolerances: the geometry functions within
1e-6 (both fp32; the frameworks may round the last bit differently);
the evaluation metrics within 1e-6 relative (numpy on both sides, the
rotations in fp32 through each package's `mat_to_quat`); trajectory IO
and the gate's verdicts exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggt_official_tpu.eval import benchmark as jbench
from iggt_official_tpu.eval import gate as jgate
from iggt_official_tpu.eval import trajectory as jtraj
from iggt_official_tpu.geometry import pose_enc as jpose
from iggt_official_tpu.geometry import projection as jproj
from iggt_official_tpu.geometry import rotation as jrot
from iggt_official_tpu_torch.eval import benchmark, gate, trajectory
from iggt_official_tpu_torch.geometry import pose_enc, projection, rotation

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

GEOM = 1e-6
REL = 1e-6


def _rotations(rng, n):
    """n random rotations, plus the near-180-degree and identity cases that
    pick each branch of `mat_to_quat`."""
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = jrot.quat_to_mat(jnp.asarray(q, jnp.float32))
    special = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                        np.diag([-1, -1, 1])]).astype(np.float32)
    return np.concatenate([np.asarray(R), special])


def _extrinsics(rng, n):
    return np.concatenate([_rotations(rng, n - 4), rng.normal(0, 1, (n, 3, 1))],
                          axis=-1).astype(np.float32)


def test_mat_to_quat_and_standardize_match_jax():
    R = _rotations(np.random.default_rng(0), 60)
    ref = np.asarray(jrot.mat_to_quat(jnp.asarray(R)))
    out = rotation.mat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(out, ref, atol=GEOM, rtol=0)
    q = np.random.default_rng(1).normal(0, 1, (20, 4)).astype(np.float32)
    np.testing.assert_array_equal(rotation.standardize_quaternion(torch.from_numpy(q)).numpy(),
                                  np.asarray(jrot.standardize_quaternion(jnp.asarray(q))))
    with pytest.raises(ValueError):
        rotation.mat_to_quat(torch.zeros(2, 3, 4))


def test_pose_encoding_and_projection_match_jax():
    rng = np.random.default_rng(2)
    ext = _extrinsics(rng, 12).reshape(2, 6, 3, 4)
    K = np.zeros((2, 6, 3, 3), np.float32)
    K[..., 0, 0] = rng.uniform(200, 400, (2, 6))
    K[..., 1, 1] = rng.uniform(200, 400, (2, 6))
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = 252.0, 168.0, 1.0
    ref = np.asarray(jpose.extri_intri_to_pose_encoding(jnp.asarray(ext), jnp.asarray(K),
                                                        (336, 504)))
    out = pose_enc.extri_intri_to_pose_encoding(torch.from_numpy(ext), torch.from_numpy(K),
                                                (336, 504))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=GEOM, rtol=0)
    pts = rng.normal(0, 2, (2, 6, 50, 3)).astype(np.float32) + np.float32([0, 0, 6])
    ruv, rz = jproj.project_world_points_to_pixels(jnp.asarray(pts), jnp.asarray(ext),
                                                   jnp.asarray(K))
    uv, z = projection.project_world_points_to_pixels(torch.from_numpy(pts),
                                                      torch.from_numpy(ext),
                                                      torch.from_numpy(K))
    np.testing.assert_allclose(z.numpy(), np.asarray(rz), atol=GEOM, rtol=0)
    np.testing.assert_allclose(uv.numpy(), np.asarray(ruv), rtol=GEOM,
                               atol=GEOM * np.abs(np.asarray(ruv)).max())


def _assert_metrics(ref, out):
    assert ref.keys() == out.keys()
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=REL, abs=1e-12), k


ALIGNMENTS = {
    "median": {},
    "lstsq": {"align_with_lstsq": True},
    "lad": {"align_with_lad": True},
    "lad2": {"align_with_lad2": True, "max_iters": 200},
    "weiszfeld": {"align_with_scale": True},
    "disparity lstsq": {"disp_input": True, "align_with_lstsq": True},
    "clipped": {"pre_clip_min": 0.2, "pre_clip_max": 40.0, "post_clip_min": 0.5,
                "post_clip_max": 30.0},
}


@pytest.mark.parametrize("align", list(ALIGNMENTS))
def test_depth_evaluation_matches_jax(align):
    """Every alignment of `depth_evaluation` on a (2, 24, 32) view stack with
    invalid and out-of-range ground truth, and a custom mask."""
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.5, 20.0, (2, 24, 32))
    gt[0, :3] = 0.0
    gt[1, -2:] = 120.0
    pred = 0.7 * gt + 0.3 + rng.normal(0, 0.4, gt.shape)
    pred = np.abs(pred) + 0.05
    mask = rng.uniform(size=gt.shape) > 0.1
    kw = dict(ALIGNMENTS[align], custom_mask=mask)
    if align == "disparity lstsq":
        pred, gt = benchmark.depth2disparity(pred), benchmark.depth2disparity(gt)
        kw["max_depth"] = None
    ref, ref_map = jbench.depth_evaluation(pred, gt, **kw)
    out, out_map = benchmark.depth_evaluation(pred, gt, **kw)
    _assert_metrics(ref, out)
    np.testing.assert_allclose(out_map, ref_map, rtol=REL, atol=0)


def test_cameras_evaluation_and_auc_match_jax():
    rng = np.random.default_rng(4)
    gt = _extrinsics(rng, 10)
    pred = gt.copy()
    pred[:, :, 3] += rng.normal(0, 0.05, (10, 3))
    noise = np.asarray(jrot.quat_to_mat(jnp.asarray(
        np.concatenate([rng.normal(0, 0.03, (10, 3)), np.ones((10, 1))], 1), jnp.float32)))
    pred[:, :, :3] = noise @ pred[:, :, :3]
    ref = jbench.cameras_evaluation(gt, pred, 10)
    out = benchmark.cameras_evaluation(gt, pred, 10)
    assert out[:4] == pytest.approx(ref[:4], rel=REL)
    for a, b in zip(ref[4:], out[4:]):
        np.testing.assert_allclose(b, a, rtol=REL, atol=1e-9)
    assert benchmark.calculate_auc(out[4], out[5]) == pytest.approx(
        jbench.calculate_auc(ref[4], ref[5]), rel=REL)
    assert benchmark.calculate_auc(out[4], out[5], 5) == pytest.approx(
        jbench.calculate_auc(ref[4], ref[5], 5), rel=REL)


def _trajectory(rng, n=12):
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = _rotations(rng, n)[:n]
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    return poses


def test_trajectory_metrics_match_jax():
    rng = np.random.default_rng(5)
    gt = _trajectory(rng)
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * gt[:, :3, 3] + rng.normal(0, 0.05, (12, 3))
    for scale in (True, False):
        ref = jtraj.eval_metrics(pred, gt, correct_scale=scale)
        out = trajectory.eval_metrics(pred, gt, correct_scale=scale)
        _assert_metrics(ref, out)
    s, R, t = trajectory.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3])
    rs, rR, rt = jtraj.umeyama_alignment(pred[:, :3, 3], gt[:, :3, 3])
    assert s == pytest.approx(rs, rel=REL)
    np.testing.assert_allclose(R, rR, atol=1e-9)
    np.testing.assert_allclose(t, rt, atol=1e-9)
    assert trajectory.rpe(gt, pred, delta=3) == pytest.approx(jtraj.rpe(gt, pred, delta=3),
                                                              rel=REL)


def test_trajectory_io_matches_jax(tmp_path):
    """TUM save / load round trip against the JAX package's files and poses;
    Sintel `.cam` and Replica `traj.txt` loaders on written files."""
    rng = np.random.default_rng(6)
    poses = _trajectory(rng, 8)
    ts = np.arange(8) * 0.5
    trajectory.save_trajectory_tum_format(poses, ts, str(tmp_path / "port.txt"))
    jtraj.save_trajectory_tum_format(poses, ts, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    out, out_ts = trajectory.load_trajectory_tum_format(str(tmp_path / "port.txt"))
    ref, ref_ts = jtraj.load_trajectory_tum_format(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(out_ts, ref_ts)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, poses, atol=1e-5)

    cams = tmp_path / "sintel"
    os.makedirs(cams)
    for i, p in enumerate(poses):
        w2c = np.linalg.inv(p)
        with open(cams / f"frame_{i:04d}.cam", "wb") as f:
            np.array([202021.25], np.float32).tofile(f)
            np.eye(3).tofile(f)
            w2c[:3].tofile(f)
    np.savetxt(tmp_path / "traj.txt", poses.reshape(8, 16))
    for fmt, path in (("sintel", cams), ("replica", tmp_path / "traj.txt"),
                      ("tum", tmp_path / "port.txt")):
        for a, b in zip(trajectory.load_traj(str(path), fmt, skip=1, stride=2, num_frames=3),
                        jtraj.load_traj(str(path), fmt, skip=1, stride=2, num_frames=3)):
            np.testing.assert_array_equal(a, b)


def _scene_preds(rng):
    depth = rng.uniform(0.5, 3.0, (2, 8, 8, 1)).astype(np.float32)
    labels = np.zeros((2, 8, 8), np.int64)
    labels[:, 4:, :] = 1
    labels[:, :2, :2] = -1
    ext = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
    ext[:, 0, 3] = [0.0, 0.5]
    return {"depth": depth, "instance_masks": labels, "extrinsic": ext}


def test_gate_matches_jax_on_synthetic_goldens(tmp_path):
    """compare_scene / gate_report / run_gate on goldens written from the
    predictions themselves (pass), from a depth scaled by 1.02 (fail), from
    the reference's coloured-mask format, and a missing golden (fail)."""
    preds = _scene_preds(np.random.default_rng(7))
    colors = np.array([[0, 0, 0], [255, 40, 3], [9, 200, 120]], np.uint8)
    goldens = {"same": dict(preds),
               "depth x1.02": dict(preds, depth=preds["depth"] * np.float32(1.02)),
               "coloured": {"depth": preds["depth"], "extrinsic": preds["extrinsic"],
                            "features": colors[preds["instance_masks"] + 1]}}
    rows = {}
    for name, golden in goldens.items():
        row = gate.compare_scene(preds, golden)
        ref = jgate.compare_scene(preds, golden)
        assert row == pytest.approx(ref, rel=REL)
        rows[name] = row
        os.makedirs(tmp_path / "gold" / name)
        np.savez(tmp_path / "gold" / name / "predictions.npz", **golden)
    assert rows["same"]["pass"] and rows["coloured"]["pass"]
    assert not rows["depth x1.02"]["pass"]
    assert rows["depth x1.02"]["depth_absrel"] > gate.GATE_DEPTH_ABSREL
    assert gate.gate_report(rows) == jgate.gate_report(rows)
    ok_scenes = {n: preds for n in ("same", "coloured")}
    table, ok = gate.run_gate(ok_scenes, str(tmp_path / "gold"), str(tmp_path / "gate.json"))
    assert ok and (table, ok) == jgate.run_gate(ok_scenes, str(tmp_path / "gold"))
    table, ok = gate.run_gate({**ok_scenes, "depth x1.02": preds, "missing": preds},
                              str(tmp_path / "gold"))
    assert not ok and table.count("FAIL") == 2
