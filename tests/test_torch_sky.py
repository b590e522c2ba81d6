"""The port's sky masking (`utils/sky.py`, the demo's ``--mask_sky``) against the
JAX package's, on the CPU.

`segment_sky_heuristic` must give the JAX package's keep-mask byte for byte
on seeded synthetic daylight, sunset, night and indoor images (the same
thresholds; the port's connected components are its native host CCL, the
JAX package's its own, with the same labels).  `load_or_compute_sky_masks`
writes ``sky_masks/`` once and reads it afterwards.  A ``mask_sky=True``
request of a scaled IGGT writes the GLBs that the JAX demo's exporter
writes from the same predictions, byte for byte, and no sky pixel's point
survives its confidence filter.  The filter (the JAX package's
`predictions_to_glb`) keeps the points at or above the ``conf_threshold``
percentile of confidence, a fixed share of them: the flag changes which
points the GLB holds, not how many, and only while the sky covers less than
that share (the zeroed sky is then all below the cut).
"""

import os
import os.path as op

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from iggt_official_tpu.app.demo import IGGTProcessor as JProcessor
from iggt_official_tpu.config import RuntimeConfig as JRuntimeConfig
from iggt_official_tpu.utils import sky as jax_sky
from iggt_official_tpu_torch.app.demo import IGGTProcessor
from iggt_official_tpu_torch.config import ModelConfig, RuntimeConfig
from iggt_official_tpu_torch.utils import sky

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

H, W = 72, 96


def _smooth_band(top, bottom, rows):
    t = np.linspace(0.0, 1.0, rows, dtype=np.float32)[:, None, None]
    return np.array(top, np.float32) + t * (np.array(bottom, np.float32) - np.array(top))


def synthetic_image(kind: str, seed: int = 0) -> np.ndarray:
    """(H, W, 3) uint8: a smooth sky band over a noisy ground, or a warm room."""
    rng = np.random.default_rng(seed)
    img = np.empty((H, W, 3), np.float32)
    sky_rows = int(0.4 * H)
    if kind == "daylight":
        img[:sky_rows] = _smooth_band((110, 160, 232), (150, 190, 245), sky_rows)
        img[sky_rows:] = (120, 100, 80) + rng.normal(0, 15, (H - sky_rows, W, 3))
    elif kind == "sunset":
        img[:sky_rows] = _smooth_band((250, 170, 90), (245, 130, 60), sky_rows)
        img[sky_rows:] = (60, 45, 35) + rng.normal(0, 12, (H - sky_rows, W, 3))
    elif kind == "night":
        img[:sky_rows] = _smooth_band((18, 28, 62), (24, 34, 70), sky_rows)
        img[sky_rows:] = (12, 11, 10) + rng.normal(0, 6, (H - sky_rows, W, 3))
    elif kind == "indoor":
        img[:] = (150, 125, 100) + rng.normal(0, 3, (H, W, 3))
        img[int(0.7 * H):] = (120, 90, 60) + rng.normal(0, 10, (H - int(0.7 * H), W, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["daylight", "sunset", "night", "indoor"])
def test_segment_sky_heuristic_matches_jax(kind):
    image = synthetic_image(kind, seed=len(kind))
    got = sky.segment_sky_heuristic(image)
    want = jax_sky.segment_sky_heuristic(image)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    sky_share = float((got == 0).mean())
    if kind == "indoor":
        assert sky_share == 0.0
    else:
        assert sky_share > 0.2


def test_sky_mask_cache(tmp_path, monkeypatch):
    """First call: every view segmented and written to sky_masks/; second
    call: read back, nothing segmented; both equal the JAX function's."""
    os.makedirs(tmp_path / "images")
    for i, kind in enumerate(("daylight", "indoor", "sunset")):
        Image.fromarray(synthetic_image(kind, seed=i)).save(tmp_path / "images" / f"{i:04d}.png")
    calls = []
    segment = sky.segment_sky_heuristic

    def counting(image):
        calls.append(image.shape)
        return segment(image)

    monkeypatch.setattr(sky, "segment_sky_heuristic", counting)
    first = sky.load_or_compute_sky_masks(str(tmp_path), (36, 48))
    assert len(calls) == 3 and sorted(os.listdir(tmp_path / "sky_masks")) == [
        "0000.png", "0001.png", "0002.png"]
    second = sky.load_or_compute_sky_masks(str(tmp_path), (36, 48))
    assert len(calls) == 3
    np.testing.assert_array_equal(first, second)
    assert first.shape == (3, 36, 48) and first.dtype == np.float32
    np.testing.assert_array_equal(first, jax_sky.load_or_compute_sky_masks(str(tmp_path), (36, 48)))


def test_mask_sky_request(tmp_path, monkeypatch):
    """A 2-view scene with a sky band through a scaled IGGT on the CPU, with
    and without ``mask_sky``: the masks are written once and read on the
    next request; each GLB equals the JAX demo exporter's on the same
    predictions; with the flag no sky pixel is kept and the point count is
    what the confidence percentile leaves."""
    cfg = ModelConfig().scaled(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56,
                               patch_embed="conv")
    scene = chip_smoke.write_scene(str(tmp_path), 2, 5, size=(90, 60), sky=True)
    runs = {}
    for flag in (False, True):
        runtime = RuntimeConfig(image_size=(70, 56), mask_sky=flag)
        proc = IGGTProcessor(model_cfg=cfg, runtime=runtime, device="cpu", seed=2)
        out = str(tmp_path / f"out_{flag}")
        runs[flag] = proc.process_scene(scene, out)["predictions"]
        jproc = JProcessor.__new__(JProcessor)
        jproc.runtime = JRuntimeConfig(image_size=(70, 56), mask_sky=flag)
        os.makedirs(tmp_path / f"jax_{flag}")
        jproc._export_glbs(runs[flag], str(tmp_path / f"jax_{flag}"), scene)
        for name in ("rgb", "mask", "pca"):
            got = (tmp_path / f"out_{flag}" / f"scene_{name}.glb").read_bytes()
            assert got == (tmp_path / f"jax_{flag}" / f"scene_{name}.glb").read_bytes(), name
    assert sorted(os.listdir(op.join(scene, "sky_masks"))) == ["0000.png", "0001.png"]
    keep = sky.load_or_compute_sky_masks(scene, (56, 70))
    assert 0.1 < 1 - keep.mean() < 0.3      # under the 30% the filter drops
    for flag, preds in runs.items():
        conf = preds["world_points_conf"] * (keep if flag else 1.0)
        kept = conf >= np.percentile(conf, 30.0)
        glb = str(tmp_path / f"out_{flag}" / "scene_rgb.glb")
        assert chip_smoke.glb_point_count(glb) == kept.sum()
        sky_kept = int((kept & (keep == 0)).sum())
        assert (sky_kept == 0) if flag else (sky_kept > 0)
    calls = []
    monkeypatch.setattr(sky, "segment_sky_heuristic", lambda image: calls.append(1))
    proc.process_scene(scene, str(tmp_path / "again"))
    assert not calls
