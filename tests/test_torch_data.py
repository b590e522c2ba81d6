"""The port's data layer (`iggt_official_tpu_torch/data/`) against the JAX
package's on the same files: views, samplers, dataset algebra, collation and
the prefetching loader byte for byte (the pose encoding within 1e-6), the
cv2-free reads and nearest resize byte-equal to cv2, and the registry.

Scenes are written with PIL; numpy's global RNG (`aug_focal` draws from it)
is seeded alike before each side reads.
"""

import json
import os

import cv2
import numpy as np
import PIL.Image
import pytest
from scipy.spatial.transform import Rotation

from iggt_official_tpu.data import datasets as jds
from iggt_official_tpu.data import loader as jloader
from iggt_official_tpu.data import rle as jrle
from iggt_official_tpu.data import samplers as jsamplers
from iggt_official_tpu.data.ranking import compute_ranking as jranking
from iggt_official_tpu.data.transforms import ColorJitter as JColorJitter
from iggt_official_tpu_torch.data import cropping, imread
from iggt_official_tpu_torch.data import datasets as tds
from iggt_official_tpu_torch.data import loader as tloader
from iggt_official_tpu_torch.data import rle as trle
from iggt_official_tpu_torch.data import samplers as tsamplers
from iggt_official_tpu_torch.data.ranking import compute_ranking as tranking
from iggt_official_tpu_torch.data.transforms import ColorJitter as TColorJitter


def write_scannet(root, n_frames=26, W=96, H=72, seed=0):
    """tests/test_data.py's Scannet layout (one sequence), written with PIL."""
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "scans", "scene0000")
    for sub in ("color", "depth", "cam"):
        os.makedirs(os.path.join(seq, sub))
    for i in range(n_frames):
        PIL.Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(seq, "color", f"{i:04d}.jpg"))
        PIL.Image.fromarray(rng.integers(500, 3000, (H, W)).astype(np.uint16)).save(
            os.path.join(seq, "depth", f"{i:04d}.png"))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = Rotation.from_rotvec([0, 0.02 * i, 0]).as_matrix()
        pose[:3, 3] = [0.05 * i, 0, 0]
        K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
        np.savez(os.path.join(seq, "cam", f"{i:04d}.npz"), pose=pose, intrinsics=K)
    return root


def write_dl3dv(root, n_frames=4, W=70, H=56, seed=3):
    """tests/test_data.py's Dl3dv-with-masklets layout."""
    rng = np.random.default_rng(seed)
    seq = os.path.join(root, "train", "seq0")
    for sub in ("rgb", "depth", "cam"):
        os.makedirs(os.path.join(seq, "dense", sub))
    masklets = []
    for i in range(n_frames):
        PIL.Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(seq, "dense", "rgb", f"frame_{i:04d}.png"))
        np.save(os.path.join(seq, "dense", "depth", f"frame_{i:04d}.npy"),
                rng.uniform(0.5, 3, (H, W)).astype(np.float32))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = Rotation.from_rotvec([0.01 * i, 0.03 * i, 0]).as_matrix()
        pose[:3, 3] = [0.1 * i, 0, 0]
        K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
        np.savez(os.path.join(seq, "dense", "cam", f"frame_{i:04d}.npz"), pose=pose,
                 intrinsic=K)
        m = np.zeros((H, W), np.uint8)
        m[: H // 2 + i] = 1
        masklets.append(jrle.encode(m > 0))
    with open(os.path.join(seq, "auto_masks.json"), "w") as f:
        json.dump({"masklet": masklets}, f)
    return root


def assert_views_equal(ref, out):
    assert len(ref) == len(out)
    for rv, ov in zip(ref, out):
        assert sorted(rv) == sorted(ov)
        for key, a in rv.items():
            b = ov[key]
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                assert a == b, key


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    return write_scannet(str(tmp_path_factory.mktemp("scannet")))


@pytest.mark.parametrize("knobs", [{}, {"aug_focal": 0.6, "aug_crop": 16}],
                         ids=["plain", "aug_focal_crop"])
def test_scannet_views_match_jax(scannet_root, knobs):
    ref_ds = jds.Scannet(scannet_root, dset="scans", resolution=(64, 48), seed=7, **knobs)
    out_ds = tds.Scannet(scannet_root, dset="scans", resolution=(64, 48), seed=7, **knobs)
    assert len(ref_ds) == len(out_ds) == 26
    for idx in [(0, 0, 4), (5, 0, 2), 11]:
        np.random.seed(123)
        ref = ref_ds[idx]
        np.random.seed(123)
        out = out_ds[idx]
        assert_views_equal(ref, out)


def test_dl3dv_masklet_views_match_jax(tmp_path, monkeypatch):
    root = write_dl3dv(str(tmp_path / "dl3dv"))
    monkeypatch.setattr(jds.Dl3dv, "min_frames", 2)
    monkeypatch.setattr(tds.Dl3dv, "min_frames", 2)
    ref_ds = jds.Dl3dv(root, dset="train", resolution=(64, 48), seed=3)
    out_ds = tds.Dl3dv(root, dset="train", resolution=(64, 48), seed=3)
    for idx in [(0, 0, 2), (2, 0, 3)]:
        ref, out = ref_ds[idx], out_ds[idx]
        assert all("instance_ids" in v for v in out)
        assert_views_equal(ref, out)


def test_samplers_match_jax():
    class Dummy:
        def __len__(self):
            return 30

    pairs = [
        (jsamplers.BatchedRandomSampler(Dummy(), 4, 3, world_size=2, rank=1),
         tsamplers.BatchedRandomSampler(Dummy(), 4, 3, world_size=2, rank=1)),
        (jsamplers.AnchorFrameSampler(Dummy(), 8, 2, 8, 2),
         tsamplers.AnchorFrameSampler(Dummy(), 8, 2, 8, 2)),
        (jsamplers.AnchorFrameSampler(Dummy(), 4, 4, 4, 1),
         tsamplers.AnchorFrameSampler(Dummy(), 4, 4, 4, 1)),
        (jsamplers.TestSampler(Dummy(), 1, 6, 2), tsamplers.TestSampler(Dummy(), 1, 6, 2)),
    ]
    for ref, out in pairs:
        for epoch in (0, 3):
            ref.set_epoch(epoch)
            out.set_epoch(epoch)
            assert list(ref) == list(out)


def test_dataset_algebra_matches_jax(scannet_root):
    ref_ds = jds.Scannet(scannet_root, dset="scans", resolution=(64, 48), seed=7)
    out_ds = tds.Scannet(scannet_root, dset="scans", resolution=(64, 48), seed=7)
    ref_big, out_big = 10 @ (2 * ref_ds + ref_ds), 10 @ (2 * out_ds + out_ds)
    assert len(ref_big) == len(out_big) == 10
    assert type(ref_big.dataset).__name__ == type(out_big.dataset).__name__ == "SeqDataset"
    ref_big.set_epoch(1)
    out_big.set_epoch(1)
    np.testing.assert_array_equal(ref_big._idxs_mapping, out_big._idxs_mapping)
    assert_views_equal(ref_big[(0, 1, 0, 8)], out_big[(0, 1, 0, 8)])


def test_collate_and_prefetching_loader_match_jax(scannet_root):
    ref_ds = jds.Scannet(scannet_root, dset="scans", resolution=(56, 42), seed=7)
    out_ds = tds.Scannet(scannet_root, dset="scans", resolution=(56, 42), seed=7)
    ref_b = jloader.collate_views(ref_ds[(3, 0, 4)])
    out_b = tloader.collate_views(out_ds[(3, 0, 4)])
    assert sorted(ref_b) == sorted(out_b)
    for key in ref_b:
        if key == "pose_enc":
            np.testing.assert_allclose(out_b[key], ref_b[key], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out_b[key], ref_b[key], err_msg=key)
    kw = dict(seq_min_len=2, seq_max_len=4, batch_size=4, shuffle=True, num_prefetch=2)
    ref_it = jloader.get_data_loader(ref_ds, **kw)
    expr = f"Scannet({scannet_root!r}, dset='scans', resolution=(56, 42), seed=7)"
    out_it = tloader.get_data_loader(expr, **kw)
    for _ in range(3):
        ref_b, out_b = next(ref_it), next(out_it)
        assert sorted(ref_b) == sorted(out_b)
        for key in ref_b:
            assert ref_b[key].shape == out_b[key].shape, key
            if key == "pose_enc":
                np.testing.assert_allclose(out_b[key], ref_b[key], rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(out_b[key], ref_b[key], err_msg=key)


def test_nearest_resize_equals_cv2():
    rng = np.random.default_rng(0)
    sizes = [(640, 480), (518, 392), (96, 72), (64, 48), (57, 43), (1000, 3), (7, 5)]
    depth = rng.uniform(0, 10, (480, 640)).astype(np.float32)
    img = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    pairs = 0
    for (sw, sh) in sizes:
        src_d = cv2.resize(depth, (sw, sh), interpolation=cv2.INTER_LINEAR)
        src_i = np.ascontiguousarray(img[:sh, :sw]) if sh <= 480 and sw <= 640 else None
        for (dw, dh) in sizes + [(sw * 2, sh * 3), (sw + 1, sh - 1 or 1)]:
            np.testing.assert_array_equal(
                cropping.resize_nearest(src_d, (dw, dh)),
                cv2.resize(src_d, (dw, dh), interpolation=cv2.INTER_NEAREST),
                err_msg=f"{(sw, sh)} -> {(dw, dh)}")
            if src_i is not None:
                np.testing.assert_array_equal(
                    cropping.resize_nearest(src_i, (dw, dh)),
                    cv2.resize(src_i, (dw, dh), interpolation=cv2.INTER_NEAREST))
            pairs += 1
    assert pairs == len(sizes) * (len(sizes) + 2)


def test_image_reads_equal_cv2(tmp_path):
    rng = np.random.default_rng(1)
    d16 = rng.integers(0, 65535, (37, 53)).astype(np.uint16)
    g8 = rng.integers(0, 255, (37, 53)).astype(np.uint8)
    rgb = rng.integers(0, 255, (37, 53, 3)).astype(np.uint8)
    rgba = rng.integers(0, 255, (37, 53, 4)).astype(np.uint8)
    files = {}
    for name, arr in [("d16.png", d16), ("g8.png", g8), ("rgb.png", rgb), ("rgba.png", rgba),
                      ("sky.jpg", g8), ("sky_rgb.jpg", rgb)]:
        files[name] = str(tmp_path / name)
        PIL.Image.fromarray(arr).save(files[name])
    for name in ("d16.png", "g8.png", "rgb.png", "rgba.png"):
        np.testing.assert_array_equal(imread.imread_unchanged(files[name]),
                                      cv2.imread(files[name], cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(
            imread.imread_anydepth(files[name]),
            cv2.imread(files[name], cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH))
    assert imread.imread_unchanged(files["d16.png"]).dtype == np.uint16
    for name in ("sky.jpg", "sky_rgb.jpg", "g8.png"):
        np.testing.assert_array_equal(imread.imread_grayscale(files[name]),
                                      cv2.imread(files[name], cv2.IMREAD_GRAYSCALE))
    exr = str(tmp_path / "d.exr")
    open(exr, "wb").close()
    with pytest.raises(ImportError, match="cv2"):
        imread.imread_unchanged(exr)


def _fresh_jax_datasets():
    """The JAX `data/datasets.py` executed anew under another name: a JAX data
    test sets `Dl3dv.min_frames = 2` on its class for the rest of its process,
    and the class bodies here hold the defined values."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_fresh_jax_datasets", jds.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registry_and_knobs_match_jax():
    ref = _fresh_jax_datasets()
    assert sorted(tds.DATASETS) == sorted(ref.DATASETS) and len(ref.DATASETS) >= 30

    def knobs(cls):
        out = {}
        for name in dir(cls):
            if name.startswith("__"):
                continue
            v = getattr(cls, name)
            if isinstance(v, (str, int, float, tuple, frozenset, type(None), np.ndarray)):
                out[name] = v.tolist() if isinstance(v, np.ndarray) else v
        return out

    for name, jcls in ref.DATASETS.items():
        assert knobs(tds.DATASETS[name]) == knobs(jcls), name
        assert tds.DATASETS[name].__name__ == jcls.__name__
    assert issubclass(tds.Dl3dv, tds.MaskletMixin) and issubclass(tds.Re10K, tds.MaskletMixin)


def test_rle_ranking_and_jitter_match_jax():
    rng = np.random.default_rng(2)
    for shape in [(7, 11), (32, 32), (1, 5), (48, 64)]:
        mask = rng.random(shape) < 0.4
        for compress in (True, False):
            enc = trle.encode(mask, compress=compress)
            assert enc == jrle.encode(mask, compress=compress)
            np.testing.assert_array_equal(trle.decode(enc), jrle.decode(enc))
            assert trle.area(enc) == jrle.area(enc) == mask.sum()
    ext = np.tile(np.eye(4), (12, 1, 1))
    ext[:, :3, :3] = Rotation.random(12, random_state=1).as_matrix()
    ext[:, :3, 3] = rng.normal(0, 2, (12, 3))
    for a, b in zip(tranking(ext.copy()), jranking(ext.copy())):
        np.testing.assert_array_equal(a, b)
    img = PIL.Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8))
    np.testing.assert_array_equal(np.asarray(TColorJitter(seed=4)(img)),
                                  np.asarray(JColorJitter(seed=4)(img)))
