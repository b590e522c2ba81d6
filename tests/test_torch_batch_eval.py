"""The port's batch evaluation (`app/batch_eval.py`) on the CPU: its scene loop
with the one-scene prefetch against serial `process_scene`, its summary
against the JAX package's aggregation, and the `--gate` exit codes.

A scaled IGGT (random weights from the seed, as the demo runs without a
checkpoint) over two scenes written by `chip_smoke.write_scene`, one with
ground truth.  The prefetched and serial runs must write the same
predictions bit for bit (same weights, same inputs, same CPU kernels); the
summaries equal the JAX package's `aggregate_summaries` exactly.
"""

import json
import os

import numpy as np
import pytest

import chip_smoke
from iggt_official_tpu.app.batch_eval import aggregate_summaries as jax_aggregate
from iggt_official_tpu_torch.app import batch_eval
from iggt_official_tpu_torch.app import demo
from iggt_official_tpu_torch.config import ModelConfig, RuntimeConfig

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

CFG = ModelConfig().scaled(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56,
                           patch_embed="conv")
SIZE = (70, 56)      # (W, H)


def _runtime():
    return RuntimeConfig(image_size=SIZE, clustering=demo.CLUSTERING_PRESETS["small"])


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    a = chip_smoke.write_scene(str(root), 2, 1, gt=True, size=(84, 63))
    b = chip_smoke.write_scene(str(root), 3, 2, size=(84, 63))
    return str(root), [a, b]


def test_batch_loop_matches_serial_process_scene(scenes, tmp_path):
    """run_scenes (prefetch on a worker thread) against process_scene run
    scene by scene: equal predictions.npz arrays, the same files, and
    summary.json counting both scenes with the GT scene's metrics."""
    root, dirs = scenes
    assert batch_eval.list_scenes(root) == sorted(dirs)
    proc = demo.IGGTProcessor(model_cfg=CFG, runtime=_runtime(), device="cpu")
    summary, kept = batch_eval.run_scenes(proc, batch_eval.list_scenes(root),
                                          str(tmp_path / "batch"), keep_predictions=True)
    serial = {}
    for scene in sorted(dirs):
        name = os.path.basename(scene)
        serial[name] = proc.process_scene(scene, str(tmp_path / "serial" / name))
    assert sorted(kept) == sorted(serial)
    for name, results in serial.items():
        with np.load(tmp_path / "batch" / name / "predictions.npz") as got, \
                np.load(tmp_path / "serial" / name / "predictions.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
        for k, v in results["predictions"].items():
            np.testing.assert_array_equal(kept[name][k], v)
        assert sorted(os.listdir(tmp_path / "batch" / name)) == sorted(
            os.listdir(tmp_path / "serial" / name))
    with open(tmp_path / "batch" / "summary.json") as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(summary))
    assert summary["num_scenes"] == 2 and summary["num_views"] == 5
    gt_name = os.path.basename(dirs[0])
    want = jax_aggregate([serial[gt_name]["evaluation"]["summary"]])
    assert summary["metrics"] == want and np.isfinite(want["depth"]["absrel"])


def test_aggregate_summaries_matches_jax():
    rng = np.random.default_rng(0)
    summaries = []
    for i in range(5):
        s = {"depth": {k: float(rng.uniform()) for k in
                       ("absrel", "inliers103", "mae", "rmse", "delta_1")},
             "pose": {"translation_error": float(rng.uniform()),
                      "rotation_error": float(rng.uniform())}}
        if i == 1:
            s["depth"]["absrel"] = float("nan")
        if i == 2:
            del s["pose"]
        summaries.append(s)
    assert batch_eval.aggregate_summaries(summaries) == jax_aggregate(summaries)
    assert batch_eval.aggregate_summaries([]) == jax_aggregate([])


def test_gate_exit_codes(scenes, tmp_path, monkeypatch):
    """`main` writes goldens, then `--gate` against them passes (exit 0,
    gate.json written) and against a golden whose depth is scaled by 1.02
    exits 1."""
    root, dirs = scenes
    scaled = demo.IGGTProcessor
    monkeypatch.setattr(demo, "IGGTProcessor", lambda model_path, runtime, device: scaled(
        model_path, model_cfg=CFG, runtime=runtime, device=device))
    base = ["--scenes_root", root, "--preset", "small", "--device", "cpu",
            "--image_size", str(SIZE[0]), str(SIZE[1])]
    gold = tmp_path / "gold"
    batch_eval.main(base + ["--save_dir", str(gold)])
    batch_eval.main(base + ["--save_dir", str(tmp_path / "ok"), "--gate",
                            "--golden_root", str(gold)])
    with open(tmp_path / "ok" / "gate.json") as f:
        assert json.load(f)["pass"]
    name = os.path.basename(dirs[1])
    path = gold / name / "predictions.npz"
    with np.load(path) as g:
        golden = {k: g[k] for k in g.files}
    golden["depth"] = golden["depth"] * np.float32(1.02)
    np.savez(path, **golden)
    with pytest.raises(SystemExit) as exc:
        batch_eval.main(base + ["--save_dir", str(tmp_path / "bad"), "--gate",
                                "--golden_root", str(gold)])
    assert exc.value.code == 1
    with open(tmp_path / "bad" / "gate.json") as f:
        report = json.load(f)
    assert not report["pass"] and not report["scenes"][name]["pass"]


def test_process_scene_takes_precomputed_preds_and_gt(scenes, tmp_path):
    """process_scene(preds=..., gt_data=...) with the forward and the ground
    truth computed beforehand writes what a plain process_scene writes, and
    evaluates against the ground truth it was given."""
    _, dirs = scenes
    proc = demo.IGGTProcessor(model_cfg=CFG, runtime=_runtime(), device="cpu")
    scene = dirs[0]
    gt_data = proc._load_gt_data(scene)
    given = proc.process_scene(scene, str(tmp_path / "given"),
                               preds=proc._run_inference(scene), gt_data=gt_data)
    plain = proc.process_scene(scene, str(tmp_path / "plain"))
    for k, v in plain["predictions"].items():
        np.testing.assert_array_equal(given["predictions"][k], v)
    assert given["evaluation"]["summary"] == plain["evaluation"]["summary"]
    assert sorted(os.listdir(tmp_path / "given")) == sorted(os.listdir(tmp_path / "plain"))
