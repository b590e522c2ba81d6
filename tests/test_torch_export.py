"""The port's host export and evaluation (colormaps, GLB, depth
visualizations, ground-truth loading, scene evaluation) against the JAX
package and matplotlib.

Tolerances, with their reasons:
- colormaps: uint8-equal to matplotlib on a 4,096-step ramp (0 and 1
  included, and values outside [0, 1] and NaN), and the tables equal;
- GLB files: byte-identical (the same numpy code; camera colours from the
  port's own gist_rainbow table, equal to matplotlib's);
- depth visualizations: the same file set, equal PNG pixels, GIF frames and
  npy contents;
- ground truth: equal depth maps and intrinsics (PIL and cv2 read the same
  16-bit PNG); extrinsics and world points to 1e-6 relative (the SE3
  inverse and the unprojection are the same formulas in torch and jnp, which
  may sum the 3-term products in another order);
- scene evaluation: reports equal to 1e-9 (the same numpy code).
"""

import json
import os
import types

import numpy as np
import pytest
from matplotlib import colormaps
from PIL import Image

import chip_smoke
from iggt_official_tpu.app.demo import IGGTProcessor as JProcessor
from iggt_official_tpu.eval.metrics import SceneEvaluator as JSceneEvaluator
from iggt_official_tpu.utils.glb import predictions_to_glb as jpredictions_to_glb
from iggt_official_tpu_torch.app.demo import IGGTProcessor as TProcessor
from iggt_official_tpu_torch.eval.metrics import SceneEvaluator
from iggt_official_tpu_torch.utils import colormaps as tcolormaps
from iggt_official_tpu_torch.utils.glb import predictions_to_glb


@pytest.mark.parametrize("name", ["jet", "viridis", "plasma", "turbo", "gist_rainbow"])
def test_colormaps_match_matplotlib(name):
    cm = colormaps[name]
    np.testing.assert_array_equal(tcolormaps.LUTS[name], cm(np.arange(256))[:, :3])
    ramp = np.concatenate([np.linspace(0, 1, 4096), [-0.25, 1.25, np.nan]])
    for x in (ramp, ramp.astype(np.float32), np.tile(ramp.astype(np.float32), (3, 1))):
        np.testing.assert_array_equal((tcolormaps.get_cmap(name)(x) * 255).astype(np.uint8),
                                      (cm(x)[..., :3] * 255).astype(np.uint8))
    np.testing.assert_array_equal(tcolormaps.get_cmap(name)(0.37), cm(0.37)[:3])


def _scene_arrays(rng, S=3, H=20, W=30):
    pts = rng.normal(0, 1, (S, H, W, 3)).astype(np.float32)
    pts[0, 0, :3] = np.nan  # non-finite points are dropped
    colors = rng.uniform(0, 1, (S, H, W, 3)).astype(np.float32)
    conf = rng.uniform(1, 3, (S, H, W)).astype(np.float32)
    q = rng.normal(0, 1, (S, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ext = np.zeros((S, 3, 4), np.float32)
    for i, (w, x, y, z) in enumerate(q):
        ext[i, :, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        ext[i, :, 3] = rng.normal(0, 1, 3)
    return pts, colors, conf, ext


@pytest.mark.parametrize("case", ["plain", "extrinsics+conf", "subsampled", "uint8 colours"])
def test_glb_is_byte_identical_to_jax(tmp_path, case):
    pts, colors, conf, ext = _scene_arrays(np.random.default_rng(3))
    kw = {"plain": dict(),
          "extrinsics+conf": dict(conf=conf, extrinsics=ext),
          "subsampled": dict(conf=conf, extrinsics=ext, max_points=500),
          "uint8 colours": dict(extrinsics=ext, conf=conf, conf_threshold=0.0)}[case]
    if case == "uint8 colours":
        colors = (colors * 255).astype(np.uint8)
    predictions_to_glb(pts, colors, path=str(tmp_path / "port.glb"), **kw)
    jpredictions_to_glb(pts, colors, path=str(tmp_path / "jax.glb"), **kw)
    got, want = (tmp_path / "port.glb").read_bytes(), (tmp_path / "jax.glb").read_bytes()
    assert got[:4] == b"glTF" and got == want


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_depth_visualizations_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    depths = rng.uniform(0.5, 6.0, (3, 24, 40)).astype(np.float32)
    depths[1, :4] = 0.0  # invalid pixels
    TProcessor._save_depth_visualizations(depths, str(tmp_path / "port"))
    jself = types.SimpleNamespace(_add_depth_scale_bar=JProcessor._add_depth_scale_bar)
    JProcessor._save_depth_visualizations(jself, depths, str(tmp_path / "jax"))
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert len(files) == 3 * 6 + 4  # per view 4 maps + plain + scale bar; grid, GIF, 2 npy
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif f.endswith(".gif"):
            ia, ib = Image.open(a), Image.open(b)
            assert ia.n_frames == ib.n_frames == 3
            for i in range(3):
                ia.seek(i)
                ib.seek(i)
                np.testing.assert_array_equal(np.asarray(ia.convert("RGB")),
                                              np.asarray(ib.convert("RGB")))
        else:
            va, vb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            np.testing.assert_array_equal(va, vb)


def test_load_gt_data_matches_jax(tmp_path):
    """Seeded 16-bit depth PNGs and cam npz files: the port reads the PNGs
    with PIL, the JAX package with cv2."""
    scene = chip_smoke.write_scene(str(tmp_path), 3, 11, gt=True, size=(64, 48))
    got = TProcessor._load_gt_data(scene)
    want = JProcessor._load_gt_data(None, scene)
    assert got["image_paths"] == want["image_paths"]
    for k in ("gt_depth", "gt_intrinsic"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("gt_extrinsic", "gt_world_points"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert TProcessor._load_gt_data(str(tmp_path)) is None  # no depth/ + cam/


def assert_reports_equal(a, b, rel=1e-9, path=""):
    """Nested report dicts equal: numbers to ``rel`` of max(1, |a|), arrays
    element by element, everything else exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_reports_equal(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_reports_equal(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) and not np.isfinite(a):
        assert not np.isfinite(b), path
    elif isinstance(a, (float, np.floating, int, np.integer)):
        assert abs(a - b) <= rel * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, path


def test_scene_evaluator_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    S, H, W = 3, 30, 40
    gt_depth = rng.uniform(0.5, 5, (S, H, W)).astype(np.float32)
    gt_depth[0, :3] = 0.0
    ext = rng.normal(0, 1, (S, 3, 4)).astype(np.float32)
    pred = {"depth": gt_depth * rng.uniform(0.8, 1.2, gt_depth.shape).astype(np.float32),
            "extrinsic": ext + rng.normal(0, 0.05, ext.shape).astype(np.float32)}
    gt = {"gt_depth": gt_depth, "gt_extrinsic": ext}
    got = SceneEvaluator().evaluate_scene(gt, pred)
    want = JSceneEvaluator().evaluate_scene(gt, pred)
    assert_reports_equal(got, want)
    SceneEvaluator().save_evaluation_report(got, str(tmp_path / "port.json"))
    JSceneEvaluator().save_evaluation_report(want, str(tmp_path / "jax.json"))
    assert_reports_equal(json.loads((tmp_path / "port.json").read_text()),
                         json.loads((tmp_path / "jax.json").read_text()))
