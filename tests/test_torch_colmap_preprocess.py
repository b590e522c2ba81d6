"""The port's COLMAP IO and converters (`iggt_official_tpu_torch/data/colmap.py`,
`iggt_official_tpu_torch/preprocess/`) against the JAX package's on the same
seeded inputs: the scenarios of `tests/test_preprocess.py` and of
`tests/test_utils_misc.py::test_colmap_roundtrip` / `::test_colmap_scene_conversion`.

Files are held byte-equal (.bin, .txt, .npy, and each array of the .npz
files), PNG pixels equal (the port writes the 16-bit depth PNG with PIL, the
JAX package with cv2), float64 geometry to 1e-12 relative, and the numpy
remap that replaces ``cv2.remap`` byte-equal to the sandbox's OpenCV (which
the JAX package calls) for nearest and linear interpolation.
"""

import os
import shutil

import cv2
import numpy as np
import PIL.Image
import pytest
from scipy.spatial.transform import Rotation

import iggt_official_tpu.data.colmap as jcolmap
import iggt_official_tpu.preprocess as jpre
import iggt_official_tpu.preprocess.arkitscenes as jark
import iggt_official_tpu.preprocess.ase as jase
import iggt_official_tpu.preprocess.blendedmvs as jbmvs
import iggt_official_tpu.preprocess.dense as jdense
import iggt_official_tpu.preprocess.dl3dv as jdl3dv
import iggt_official_tpu.preprocess.edit_resolution as jedit
import iggt_official_tpu.preprocess.habitat as jhab
import iggt_official_tpu.preprocess.scannetpp as jscan
import iggt_official_tpu_torch.data.colmap as tcolmap
import iggt_official_tpu_torch.preprocess as tpre
import iggt_official_tpu_torch.preprocess.arkitscenes as tark
import iggt_official_tpu_torch.preprocess.ase as tase
import iggt_official_tpu_torch.preprocess.blendedmvs as tbmvs
import iggt_official_tpu_torch.preprocess.dense as tdense
import iggt_official_tpu_torch.preprocess.dl3dv as tdl3dv
import iggt_official_tpu_torch.preprocess.edit_resolution as tedit
import iggt_official_tpu_torch.preprocess.habitat as thab
import iggt_official_tpu_torch.preprocess.scannetpp as tscan

GEOM_RTOL = 1e-12


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_trees_equal(a, b, png_pixels=False):
    """Same file names under a and b; .npz compared array by array, .png by
    pixels (cv2 IMREAD_UNCHANGED) when ``png_pixels``, the rest byte for byte."""
    names_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b and names_a
    for name in names_a:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), (name, k)
        elif png_pixels and name.endswith(".png"):
            ia = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
            ib = cv2.imread(pb, cv2.IMREAD_UNCHANGED)
            assert ia.dtype == ib.dtype and np.array_equal(ia, ib), name
        else:
            assert read_bytes(pa) == read_bytes(pb), name


def test_colmap_dense_array_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    for shape in [(7, 5), (6, 4, 3)]:
        arr = rng.normal(0, 1, shape).astype(np.float32)
        jdense.write_colmap_array(arr, str(tmp_path / "j.bin"))
        tdense.write_colmap_array(arr, str(tmp_path / "t.bin"))
        assert read_bytes(tmp_path / "j.bin") == read_bytes(tmp_path / "t.bin")
        got = tdense.read_colmap_array(str(tmp_path / "j.bin"))
        want = jdense.read_colmap_array(str(tmp_path / "j.bin"))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(got, arr.squeeze())
    (tmp_path / "bad.bin").write_bytes(b"7&5")
    for mod in (jdense, tdense):
        with pytest.raises(ValueError, match="truncated"):
            mod.read_colmap_array(str(tmp_path / "bad.bin"))


def test_dl3dv_clamp_depth():
    rng = np.random.default_rng(1)
    d = rng.uniform(-2, 700, (12, 16)).astype(np.float32)
    d[0, :4] = 0
    for kw in ({}, {"min_depth": 1.0, "max_depth": 500.0}, {"size": (6, 4)}, {"size": (40, 30)}):
        got, want = tdl3dv.clamp_depth(d, **kw), jdl3dv.clamp_depth(d, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_dl3dv_scene_extraction(tmp_path):
    rng = np.random.default_rng(1)
    for side in ("jax", "torch"):
        root = tmp_path / side
        depth_dir = root / "colmap" / "dense" / "stereo" / "depth_maps"
        depth_dir.mkdir(parents=True)
        (root / "images_8").mkdir()
        PIL.Image.new("RGB", (8, 6)).save(root / "images_8" / "frame_00001.png")
    for i in range(3):
        d = rng.uniform(-1, 10, (12, 16)).astype(np.float32)
        for side in ("jax", "torch"):
            jdense.write_colmap_array(d, str(tmp_path / side / "colmap" / "dense" / "stereo"
                                             / "depth_maps" / f"frame_{i:05d}.png.geometric.bin"))
    for side in ("jax", "torch"):   # an empty bin and a non-geometric file are skipped
        dd = tmp_path / side / "colmap" / "dense" / "stereo" / "depth_maps"
        (dd / "frame_00009.png.geometric.bin").write_bytes(b"")
        (dd / "frame_00001.png.photometric.bin").write_bytes(b"x")
    assert jdl3dv.process_scene(str(tmp_path / "jax"), depth_thre=8.0) == 3
    assert tdl3dv.process_scene(str(tmp_path / "torch"), depth_thre=8.0) == 3
    assert_trees_equal(tmp_path / "jax" / "depths", tmp_path / "torch" / "depths")
    assert np.load(tmp_path / "torch" / "depths" / "frame_00001.npy").shape == (6, 8)


@pytest.mark.parametrize("model,params", [("PINHOLE", [80.0, 40.0, 50.0, 25.0]),
                                          ("SIMPLE_PINHOLE", [80.0, 50.0, 25.0]),
                                          ("OPENCV", [80.0, 70.0, 50.0, 25.0, 0.1, -0.05,
                                                      0.001, 0.002])])
def test_scale_colmap_cameras(model, params):
    cams_j = {1: jcolmap.Camera(1, model, 100, 50, np.array(params))}
    cams_t = {1: tcolmap.Camera(1, model, 100, 50, np.array(params))}
    for w, h in ((200, 100), (33, 17)):
        want = jdl3dv.scale_colmap_cameras(cams_j, w, h)[1]
        got = tdl3dv.scale_colmap_cameras(cams_t, w, h)[1]
        assert (got.width, got.height, got.model) == (want.width, want.height, want.model)
        assert got.params.tobytes() == want.params.tobytes()
    with pytest.raises(ValueError, match="unsupported"):
        tdl3dv.scale_colmap_cameras({1: tcolmap.Camera(1, "FOV", 1, 1, np.ones(5))}, 2, 2)


def write_blendedmvs(root, rng, views=2):
    for sub in ("cams", "blended_images", "rendered_depth_maps"):
        (root / sub).mkdir(parents=True)
    for v in range(views):
        name = f"{v:08d}"
        K = np.array([[100.0 + v, 0, 64], [0, 101.0, 48], [0, 0, 1]])
        w2c = np.eye(4)
        w2c[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
        w2c[:3, 3] = rng.normal(0, 1, 3)
        with open(root / "cams" / f"{name}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for row in w2c:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
            f.write("\nintrinsic\n")
            for row in K:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
        PIL.Image.fromarray(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)).save(
            root / "blended_images" / f"{name}.jpg")
        depth = rng.uniform(1, 4, (96, 128)).astype(np.float32)
        with open(root / "rendered_depth_maps" / f"{name}.pfm", "wb") as f:
            f.write(b"Pf\n128 96\n-1.0\n")
            f.write(depth[::-1].tobytes())
    (root / "cams" / "pair.txt").write_text("0\n")


def test_blendedmvs_cam_and_scene(tmp_path):
    write_blendedmvs(tmp_path / "seq", np.random.default_rng(2))
    cam = str(tmp_path / "seq" / "cams" / "00000001_cam.txt")
    for got, want in zip(tbmvs.load_cam_txt(cam), jbmvs.load_cam_txt(cam)):
        np.testing.assert_allclose(got, want, rtol=GEOM_RTOL, atol=0)
    for res in ((64, 48), (100, 60)):
        assert jbmvs.convert_scene(str(tmp_path / "seq"), str(tmp_path / f"j{res}"), res) == 2
        assert tbmvs.convert_scene(str(tmp_path / "seq"), str(tmp_path / f"t{res}"), res) == 2
        assert_trees_equal(tmp_path / f"j{res}", tmp_path / f"t{res}")


def test_arkitscenes_traj_and_orientation(tmp_path):
    rng = np.random.default_rng(3)
    traj = tmp_path / "lowres_wide.traj"
    rows = [f"{1000 + 0.1 * i + 0.0004:.4f} " + " ".join(f"{v:.6f}" for v in rng.normal(0, 0.5, 6))
            for i in range(6)]
    traj.write_text("\n".join(rows) + "\nbad line\n")
    (ts_t, poses_t), (ts_j, poses_j) = tark.read_traj(str(traj)), jark.read_traj(str(traj))
    assert ts_t == ts_j and len(poses_t) == 6
    for a, b in zip(poses_t, poses_j):
        np.testing.assert_allclose(a, b, rtol=GEOM_RTOL, atol=0)
    for v in (999.0, 1000.25, 1000.31, 1001.0):
        assert tark.closest(v, ts_t) == jark.closest(v, ts_j)
    pincam = tmp_path / "a.pincam"
    pincam.write_text("256 192 100.5 101.0 128.0 96.0\n")
    np.testing.assert_array_equal(tark.read_pincam(str(pincam)), jark.read_pincam(str(pincam)))
    up = np.eye(4)
    up[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
    for poses in ([up], [np.diag([1.0, -1, -1, 1]) @ up],
                  [Rotation.from_rotvec([0, a, 0]).as_matrix() for a in (0.3, 1.2)], poses_t, []):
        poses = [p if p.shape == (4, 4) else np.block([[p, np.zeros((3, 1))], [np.zeros((1, 3)), 1]])
                 for p in poses]
        (lt, rt), (lj, rj) = tark.find_scene_orientation(poses), jark.find_scene_orientation(poses)
        assert lt == lj
        np.testing.assert_allclose(rt, rj, rtol=GEOM_RTOL, atol=0)


def test_arkitscenes_convert_scene(tmp_path):
    rng = np.random.default_rng(4)
    scene = tmp_path / "41069025"
    for sub in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        (scene / sub).mkdir(parents=True)
    lines = []
    for i in range(4):
        t = 100.0 + i * 0.1
        lines.append(f"{t:.3f} " + " ".join(f"{v:.5f}" for v in rng.normal(0, 0.4, 6)))
        name = f"41069025_{t + 0.0004:.3f}"
        PIL.Image.fromarray(rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)).save(
            scene / "lowres_wide" / f"{name}.png")
        PIL.Image.fromarray(rng.integers(300, 4000, (12, 16)).astype(np.uint16)).save(
            scene / "lowres_depth" / f"{name}.png")
        (scene / "lowres_wide_intrinsics" / f"{name}.pincam").write_text(
            "16 12 10.0 10.0 8.0 6.0\n")
    (scene / "lowres_wide.traj").write_text("\n".join(lines) + "\n")
    assert jark.convert_scene(str(scene), str(tmp_path / "j"), 3) == \
        tark.convert_scene(str(scene), str(tmp_path / "t"), 3)
    assert_trees_equal(tmp_path / "j", tmp_path / "t")


def test_ase_geometry():
    rng = np.random.default_rng(5)
    K = np.array([[50.0, 0, 32], [0, 51.0, 24], [0, 0, 1]])
    dist = rng.uniform(0.5, 8, (48, 64))
    np.testing.assert_allclose(tase.distance_to_depth(K, dist), jase.distance_to_depth(K, dist),
                               rtol=GEOM_RTOL, atol=0)
    uv = rng.uniform(0, 64, (20, 2))
    np.testing.assert_allclose(tase.distance_to_depth(K, dist[0, :20], uv),
                               jase.distance_to_depth(K, dist[0, :20], uv), rtol=GEOM_RTOL, atol=0)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec([0.1, 0.2, 0.3]).as_matrix()
    T[:3, 3] = [0, 0, 2.0]
    pts = rng.normal(0, 1, (30, 3))
    np.testing.assert_allclose(tase.transform_3d_points(T, pts),
                               jase.transform_3d_points(T, pts), rtol=GEOM_RTOL, atol=0)
    depth = np.where(rng.uniform(0, 1, (48, 64)) < 0.3, 0, dist).astype(np.float32)
    rgb = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    for got, want in zip(tase.unproject(K, depth, rgb), jase.unproject(K, depth, rgb)):
        np.testing.assert_allclose(got, want, rtol=GEOM_RTOL, atol=0)
    np.testing.assert_allclose(tase.unproject(K, depth), jase.unproject(K, depth),
                               rtol=GEOM_RTOL, atol=0)
    with pytest.raises(ImportError, match="projectaria_tools"):
        tase.aria_export_to_scannet("a", "b")


def test_scannetpp_copy(tmp_path):
    scene = "scene0"
    (tmp_path / "processed" / scene / "images").mkdir(parents=True)
    (tmp_path / "obj_ids" / scene).mkdir(parents=True)
    for i in range(4):
        PIL.Image.new("RGB", (4, 4)).save(tmp_path / "processed" / scene / "images" / f"f{i}.jpg")
    for i in (0, 1, 3):
        PIL.Image.new("L", (4, 4), i).save(tmp_path / "obj_ids" / scene / f"f{i}.png")
    want = jscan.copy_semantic_annotations(str(tmp_path / "processed"), str(tmp_path / "obj_ids"),
                                           scene)
    shutil.rmtree(tmp_path / "processed" / scene / "obj_ids")
    got = tscan.copy_semantic_annotations(str(tmp_path / "processed"), str(tmp_path / "obj_ids"),
                                          scene)
    assert got == want == (3, ["f2"])
    assert tscan.copy_all_scenes(str(tmp_path / "processed"), str(tmp_path / "obj_ids")) == \
        jscan.copy_all_scenes(str(tmp_path / "processed"), str(tmp_path / "obj_ids"))


def test_habitat_projections_roundtrip():
    rng = np.random.default_rng(6)
    u, v = rng.uniform(0, 200, 50), rng.uniform(0, 100, 50)
    eq_t, eq_j = thab.EquirectangularProjection(100, 200), jhab.EquirectangularProjection(100, 200)
    np.testing.assert_allclose(eq_t.unproject(u, v), eq_j.unproject(u, v), rtol=GEOM_RTOL, atol=0)
    rays = rng.normal(0, 1, (40, 3))
    for a, b in zip(eq_t.project(rays), eq_j.project(rays)):
        np.testing.assert_allclose(a, b, rtol=GEOM_RTOL, atol=0)
    assert thab.compute_camera_intrinsics(48, 64, 73.0) == jhab.compute_camera_intrinsics(48, 64, 73.0)
    f, cu, cv = thab.compute_camera_intrinsics(48, 64, 90.0)
    K = np.array([[f, 0, cu], [0, f, cv], [0, 0, 1.0]])
    R = Rotation.from_rotvec([0.2, -0.4, 0.1]).as_matrix()
    for base_t, base_j in ((thab.PerspectiveProjection(K, 48, 64),
                            jhab.PerspectiveProjection(K, 48, 64)), (eq_t, eq_j)):
        for rot in (None, R):
            pt, pj = thab.RotatedProjection(base_t, rot), jhab.RotatedProjection(base_j, rot)
            for a, b in zip(pt.project(rays), pj.project(rays)):
                np.testing.assert_allclose(a, b, rtol=GEOM_RTOL, atol=0)
            np.testing.assert_allclose(thab.get_projection_rays(pt), jhab.get_projection_rays(pj),
                                       rtol=GEOM_RTOL, atol=0)
    np.random.seed(0)
    want = jhab.get_projection_rays(eq_j, noise_level=1.0)
    np.random.seed(0)
    np.testing.assert_allclose(thab.get_projection_rays(eq_t, noise_level=1.0), want,
                               rtol=GEOM_RTOL, atol=0)


def remap_inputs(rng, H, W, dtype, channels):
    shape = (H, W) if channels is None else (H, W, channels)
    if dtype == np.uint8:
        img = rng.integers(0, 256, shape).astype(dtype)
    elif dtype in (np.uint16, np.int32):
        img = rng.integers(0, 65536, shape).astype(dtype)
    else:
        img = rng.normal(0, 3, shape).astype(dtype)
    map_u = rng.uniform(-2 * W, 3 * W, (37, 53)).astype(np.float32)
    map_v = rng.uniform(-2 * H, 3 * H, (37, 53)).astype(np.float32)
    # exact halves and integers, where rounding rules show
    map_u[:4] = np.round(map_u[:4]) + 0.5
    map_v[4:8] = np.round(map_v[4:8])
    return img, map_u, map_v


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.uint8, None), (np.float32, None),
                                            (np.float32, 3), (np.uint16, 1), (np.float64, 3)])
def test_remap_wrap_matches_opencv(dtype, channels):
    """The numpy remap against the sandbox's cv2.remap (BORDER_WRAP, float32
    maps), byte for byte, nearest and linear."""
    rng = np.random.default_rng(7)
    img, map_u, map_v = remap_inputs(rng, 20, 30, dtype, channels)
    for nearest, interp in ((True, cv2.INTER_NEAREST), (False, cv2.INTER_LINEAR)):
        want = cv2.remap(img, map_u, map_v, interpolation=interp, borderMode=cv2.BORDER_WRAP)
        got = thab.remap_wrap(img, map_u, map_v, nearest=nearest)
        if channels == 1:
            got = got[..., 0]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (nearest, np.abs(got.astype(float) - want).max())
    with pytest.raises(TypeError, match="int32"):
        thab.remap_wrap(img.astype(np.int32), map_u, map_v)


def test_habitat_crop_extraction():
    H, W = 100, 200
    eq_j, eq_t = jhab.EquirectangularProjection(H, W), thab.EquirectangularProjection(H, W)
    rays = jhab.get_projection_rays(eq_j)
    color = ((rays + 1) * 127.5).astype(np.uint8)
    distance = np.random.default_rng(8).uniform(1.0, 3.0, (H, W)).astype(np.float32)
    f, cu, cv = jhab.compute_camera_intrinsics(32, 40, 60.0)
    K = np.array([[f, 0, cu], [0, f, cv], [0, 0, 1.0]])
    R = Rotation.from_rotvec([0.1, 2.5, 0.0]).as_matrix()   # looks across the seam
    for jit in (0, 3):
        out = []
        for mod, eq in ((jhab, eq_j), (thab, eq_t)):
            crop = mod.RotatedProjection(mod.PerspectiveProjection(K, 32, 40), R)
            np.random.seed(1)
            out.append(mod.extract_cropped_camera(
                eq, crop, color, distance, mod.compute_pointmap(rays, distance, [0.5, 0, 0]),
                pixel_jittering_iterations=jit))
        for want, got in zip(*out):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    proj_t = thab.RotatedProjection(thab.PerspectiveProjection(K, 32, 40), R.T)
    proj_j = jhab.RotatedProjection(jhab.PerspectiveProjection(K, 32, 40), R.T)
    d_t = thab.perspective_projection_to_dict(proj_t, [1.0, 2.0, 3.0])
    assert d_t == jhab.perspective_projection_to_dict(proj_j, [1.0, 2.0, 3.0])
    (pt, pos_t), (pj, pos_j) = (thab.dict_to_perspective_projection(d_t),
                                jhab.dict_to_perspective_projection(d_t))
    assert pos_t == pos_j
    np.testing.assert_array_equal(pt.base_projection.K, pj.base_projection.K)
    with pytest.raises(ImportError, match="habitat-sim"):
        thab.render_environment_map()


def test_edit_resolution_tool(tmp_path):
    for side, mod, cm in (("j", jedit, jcolmap), ("t", tedit, tcolmap)):
        sparse = tmp_path / side / "colmap" / "sparse" / "0"
        os.makedirs(sparse)
        os.makedirs(tmp_path / side / "images_8")
        (tmp_path / side / "images_8" / "a_notes.txt").write_text("not an image")
        PIL.Image.new("RGB", (480, 270)).save(tmp_path / side / "images_8" / "f0001.png")
        cams = {1: cm.Camera(1, "PINHOLE", 1920, 1080, np.array([1000.0, 1001.0, 960.0, 540.0])),
                2: cm.Camera(2, "SIMPLE_PINHOLE", 1920, 1080, np.array([1000.0, 960.0, 540.0])),
                3: cm.Camera(3, "OPENCV", 1920, 1080, np.array([1e3, 1e3, 960, 540, .1, .2, 0, 0])),
                4: cm.Camera(4, "FOV", 1920, 1080, np.array([1e3, 1e3, 960, 540, 0.5]))}
        cm.write_cameras_binary(cams, str(sparse / "cameras.bin"))
        assert mod.edit_scene_resolution(str(tmp_path / side))
        assert not mod.edit_scene_resolution(str(tmp_path / side))
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    got = tcolmap.read_cameras_binary(str(tmp_path / "t" / "colmap" / "sparse" / "0"
                                          / "cameras.bin"))
    np.testing.assert_array_equal(got[1].params, [250.0, 250.25, 240.0, 135.0])
    for side, mod in (("j", jedit), ("t", tedit)):
        os.remove(tmp_path / side / "colmap" / "sparse" / "0" / "cameras.bin.backup")
        with pytest.raises(FileNotFoundError, match="no readable images"):
            mod.edit_scene_resolution(str(tmp_path / side), images_rel="missing")


def colmap_model(mod, rng, n_images=4):
    cameras = {1: mod.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 501.0, 320.0, 240.0])),
               2: mod.Camera(2, "OPENCV", 320, 240, rng.normal(0, 1, 8))}
    images = {}
    for i in range(1, n_images + 1):
        q = mod.rotmat2qvec(Rotation.random(random_state=i).as_matrix())
        xys = np.zeros((0, 2)) if i == 2 else rng.uniform(0, 640, (5, 2))
        p3d = np.zeros((0,), np.int64) if i == 2 else np.array([1, -1, 2, -1, 3])
        images[i] = mod.Image(i, q, rng.normal(0, 1, 3), 1 + i % 2, f"img_{i}.jpg", xys, p3d)
    points = {p: mod.Point3D(p, rng.normal(0, 1, 3), rng.integers(0, 256, 3), float(rng.uniform()),
                             np.array([1, 3]), np.array([p - 1, 0]))
              for p in (1, 2, 3)}
    return cameras, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_roundtrip(tmp_path, ext):
    for side, mod in (("j", jcolmap), ("t", tcolmap)):
        mod.write_model(*colmap_model(mod, np.random.default_rng(9)), str(tmp_path / side), ext=ext)
    assert_trees_equal(tmp_path / "j", tmp_path / "t")
    want = jcolmap.read_model(str(tmp_path / "j"), ext=ext)
    got = tcolmap.read_model(str(tmp_path / "j"), ext=ext)
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            assert type(w[k]).__name__ == type(g[k]).__name__
            for a, b in zip(w[k], g[k]):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                else:
                    assert a == b
    for i in want[1]:
        np.testing.assert_allclose(got[1][i].qvec2rotmat(), want[1][i].qvec2rotmat(),
                                   rtol=GEOM_RTOL, atol=0)
        np.testing.assert_allclose(tcolmap.rotmat2qvec(got[1][i].qvec2rotmat()),
                                   jcolmap.rotmat2qvec(want[1][i].qvec2rotmat()),
                                   rtol=GEOM_RTOL, atol=1e-15)
    assert tcolmap.CAMERA_MODELS == [tuple(m) for m in jcolmap.CAMERA_MODELS]


def test_colmap_scene_conversion(tmp_path):
    rng = np.random.default_rng(0)
    images_dir = tmp_path / "images"
    os.makedirs(images_dir)
    depths = {}
    for side, mod in (("j", jcolmap), ("t", tcolmap)):
        r = np.random.default_rng(10)
        cameras = {1: mod.Camera(1, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0])),
                   2: mod.Camera(2, "SIMPLE_RADIAL", 64, 48, np.array([40.0, 32.0, 24.0, 0.1]))}
        images = {}
        for i in range(1, 5):
            name = f"frame_{i}.jpg"
            R = Rotation.random(random_state=i).as_matrix()
            images[i] = mod.Image(i, mod.rotmat2qvec(R), r.normal(0, 1, 3), 1 + i % 2, name,
                                  np.zeros((0, 2)), np.zeros(0, np.int64))
        mod.write_model(cameras, images, {}, str(tmp_path / f"sparse_{side}"))
    for i in range(1, 5):
        PIL.Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            images_dir / f"frame_{i}.jpg")
        if i != 3:                               # frame 3 has no depth map
            depths[f"frame_{i}.jpg"] = rng.uniform(0.0, 70.0, (48, 64)).astype(np.float32)
    os.remove(images_dir / "frame_4.jpg")        # and frame 4 no image: skipped
    n_j = jpre.convert_colmap_scene(str(tmp_path / "sparse_j"), str(images_dir),
                                    str(tmp_path / "j"), seq_name="seq0", depth_maps=depths)
    n_t = tpre.convert_colmap_scene(str(tmp_path / "sparse_t"), str(images_dir),
                                    str(tmp_path / "t"), seq_name="seq0", depth_maps=depths)
    assert n_j == n_t == 3
    assert_trees_equal(tmp_path / "j", tmp_path / "t", png_pixels=True)
    png = cv2.imread(str(tmp_path / "t" / "seq0" / "depth" / "000000.png"), cv2.IMREAD_UNCHANGED)
    assert png.dtype == np.uint16
    np.testing.assert_array_equal(
        png, np.clip(depths["frame_1.jpg"] * 1000, 0, 65535).astype(np.uint16))
    cams = tcolmap.read_cameras_binary(str(tmp_path / "sparse_t" / "cameras.bin"))
    for cam in cams.values():
        np.testing.assert_array_equal(tpre.colmap_scene.camera_to_intrinsics(cam),
                                      jpre.colmap_scene.camera_to_intrinsics(cam))
