"""The port's clustering (CPU) against the JAX package, module by module and
as the demo's whole post-processing.

Tolerances, with their reasons:
- rank-Boruvka MST on identical kNN arrays: equal edge SET, weights and core
  (the same fp32 max() of the same inputs, the same (weight, edge id) ranks);
- host path: equal masks (the same native code on the same subsample);
- device path on CPU tensors (brute-force kNN and rank Boruvka where the
  JAX package runs the native kNN and MST): >= 0.995 pixel agreement, as in
  tests/test_cluster_device.py; the two kNNs round distances differently,
  which may move near-tied MST edges;
- `weighted_hdbscan` on a tensor vs on the same numpy points: equal labels;
- native labelling vs its Python spec, and the refinement: equal labels;
- whole `_post_process`: poses, intrinsics and unprojected points 1e-5 abs,
  PCA colours 1e-5 per channel up to the eigenvector sign, equal cluster
  count and >= 0.999 mask agreement (the smoothed features differ by a few
  ulps of summation order, which may move boundary pixels), equal colours
  wherever the masks are equal.
"""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from iggt_official_tpu.app.demo import IGGTProcessor as JProcessor
from iggt_official_tpu.config import ClusteringConfig as JClusteringConfig
from iggt_official_tpu.config import RuntimeConfig as JRuntimeConfig
from iggt_official_tpu.ops import cluster as jcl
from iggt_official_tpu.ops.cluster_device import mreach_mst_device as jmst
from iggt_official_tpu_torch import native
from iggt_official_tpu_torch.app.demo import IGGTProcessor as TProcessor
from iggt_official_tpu_torch.config import ClusteringConfig, RuntimeConfig
from iggt_official_tpu_torch.ops import cluster as tcl
from iggt_official_tpu_torch.ops.cluster_device import mreach_mst_device as tmst
from iggt_official_tpu_torch.ops.knn import brute_knn

from tests.test_torch_postproc import assert_close_up_to_flip


def _blobs(rng, n, d=8, k_inst=6, sigma=0.05):
    centers = rng.normal(0, 1, (k_inst, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, k_inst, n)
    return (centers[lab] + rng.normal(0, sigma, (n, d))).astype(np.float32)


def _edge_set(a, b):
    return {frozenset((int(x), int(y))) for x, y in zip(a, b)}


def test_boruvka_rank_matches_jax_and_native():
    rng = np.random.default_rng(1)
    pts = _blobs(rng, 4096)
    ms = 5
    d, i = native.knn_query(pts, 32)  # exact, self at column 0
    ta, tb, tw, tcore = tmst(torch.from_numpy(d), torch.from_numpy(i), ms)
    ja, jb, jw, jcore = jmst(jnp.asarray(d), jnp.asarray(i), ms)
    na, nb, nw = native.mst_knn(d.astype(np.float64), i, d[:, ms - 1].astype(np.float64))

    assert len(ta) == len(ja) == len(na) >= pts.shape[0] - 10
    assert _edge_set(ta, tb) == _edge_set(ja, jb) == _edge_set(na, nb)
    np.testing.assert_array_equal(tw, jw)       # both in (weight, edge id) order
    np.testing.assert_array_equal(tcore, jcore)
    w = np.ones(pts.shape[0], np.float64)
    np.testing.assert_array_equal(tcl._labels_from_edges(ta, tb, tw, w, tcore, 0.06, 40, False),
                                  jcl._labels_from_edges(ja, jb, jw, w, jcore, 0.06, 40, False))


def test_device_branch_functions_match_host_hdbscan():
    """The card branch of `weighted_hdbscan` (exact brute kNN, rank Boruvka)
    on CPU tensors against the host branch: self first in the kNN, equal
    core distances, and the same labels."""
    rng = np.random.default_rng(4)
    pts = _blobs(rng, 3000, sigma=0.04)
    dist, idx = brute_knn(torch.from_numpy(pts), torch.from_numpy(pts), 64)
    assert (idx[:, 0] == torch.arange(3000)).all()
    hd, _ = native.knn_query(pts, 64)
    # |q|^2 + |r|^2 - 2 q.r cancels: squared distances agree to a few fp32
    # ulps of |q|^2 (~1), so compare those, not their square roots
    np.testing.assert_allclose(dist.numpy() ** 2, hd ** 2, rtol=0, atol=1e-6)
    a, b, dd, core = tmst(dist, idx, 10)
    w = np.ones(3000)
    dev = tcl._labels_from_edges(a, b, dd, w, core, 0.06, 50, False)
    host = tcl.weighted_hdbscan(pts, w, 0.06, 10, 50)
    assert len(np.unique(dev)) == len(np.unique(host)) > 2
    assert (dev == host).mean() >= 0.995


def _mv_case():
    rng = np.random.default_rng(2)
    n, h, w = 3, 48, 48
    flat = _blobs(rng, n * h * w, k_inst=5, sigma=0.04)
    return flat, (n, h, w), dict(eps=0.06, min_samples=60, min_cluster_size=200, budget=4096)


def test_cluster_mv_host_matches_jax():
    flat, shape, kw = _mv_case()
    got = tcl._cluster_mv_host(flat, *shape, exact=False, **kw)
    want = jcl._cluster_mv_host(flat, *shape, exact=False, **kw)
    assert got.shape == shape and len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, want)


def test_cluster_mv_exact_matches_jax():
    """``exact``: every pixel clustered with the unscaled parameters, by the
    host path (equal masks) and by the device path's code on CPU tensors."""
    flat, shape, kw = _mv_case()
    got = tcl._cluster_mv_host(flat, *shape, exact=True, **kw)
    want = jcl._cluster_mv_host(flat, *shape, exact=True, **kw)
    assert got.shape == shape and len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, want)
    dev = tcl._cluster_mv_device(torch.from_numpy(flat), *shape,
                                 **{**kw, "budget": flat.shape[0]})
    assert (dev == want).mean() >= 0.995


@pytest.mark.parametrize("K,ms", [(50, 100), (100, 100), (3000, 10)])
def test_weighted_hdbscan_tensor_matches_numpy(K, ms):
    """The tensor branch (brute kNN, rank Boruvka) against the numpy branch,
    down to sets smaller than min_samples (infinite cores: all noise)."""
    rng = np.random.default_rng(K)
    pts = _blobs(rng, K, k_inst=4, sigma=0.04)
    w = np.ones(K)
    want = tcl.weighted_hdbscan(pts, w, 0.06, ms, 20)
    np.testing.assert_array_equal(tcl.weighted_hdbscan(torch.from_numpy(pts), w, 0.06, ms, 20),
                                  want)
    assert (len(np.unique(want)) > 2) == (K > ms)
    with pytest.raises(ValueError, match="unit weights"):
        tcl.weighted_hdbscan(torch.from_numpy(pts), w * 2, 0.06, ms, 20)


def test_cluster_mv_device_on_cpu_tensors_matches_jax():
    flat, shape, kw = _mv_case()
    got = tcl._cluster_mv_device(torch.from_numpy(flat), *shape, **kw)
    want = jcl._cluster_mv_device(jnp.asarray(flat), *shape, **kw)
    assert got.shape == want.shape == shape
    assert (got == want).mean() >= 0.995
    assert (got == tcl._cluster_mv_host(flat, *shape, exact=False, **kw)).mean() >= 0.995


def test_native_labels_match_python_spec():
    rng = np.random.default_rng(5)
    pts = _blobs(rng, 2500, sigma=0.05)
    w = np.ones(2500)
    core, d, i = tcl._weighted_core_distances(pts, w, 8)
    a, b, dd = tcl._mreach_mst(core, d, i)
    order = np.lexsort((np.maximum(a, b), np.minimum(a, b), dd))
    a, b, dd = a[order], b[order], dd[order]
    for eps, mcs in ((0.06, 40), (0.0, 40), (0.3, 100)):
        np.testing.assert_array_equal(
            tcl._labels_from_edges(a, b, dd, w, core, eps, mcs, False),
            tcl._labels_from_mst(a, b, dd, w, core, eps, mcs, False))


def test_bridge_merge_matches_jax():
    """tests/test_cluster_refine.py::test_bridge_merge_restored through both
    packages: two balls joined by a sub-eps bridge the thinning severed."""
    rng = np.random.default_rng(0)

    def ball(center, n, r):
        p = rng.normal(0, r / 2, (n, 2)) + center
        return np.clip(p - center, -r, r) + center

    a = ball((0.0, 0.0), 2000, 0.15)
    b = ball((0.5, 0.0), 2000, 0.15)
    tx = np.linspace(0.12, 0.38, 400)
    flat = np.concatenate([a, np.stack([tx, rng.normal(0, 0.004, 400)], 1), b])
    flat = flat.astype(np.float32)
    keep = np.concatenate([np.arange(0, 2000, 4), np.arange(2000, 2400, 40),
                           np.arange(2400, 4400, 4)])
    pts = flat[keep]
    labels = (pts[:, 0] > 0.25).astype(np.int64)
    j_all = native.nearest_neighbor(pts, flat)
    args = (flat, pts, labels, j_all, 0.06, 10, 200)
    got = tcl._boundary_merge_full_density(*args)
    np.testing.assert_array_equal(got, jcl._boundary_merge_full_density(*args))
    assert len(np.unique(got)) == 1


def test_post_process_matches_jax():
    """The demo's whole `_post_process` on one synthetic prediction set: a
    Voronoi scene at 2 views 96x128 (below 32,768 pixels: the host path in
    both packages), seeded poses with positive fields of view."""
    S, H, W = 2, 96, 128
    pts, fts = chip_smoke.voronoi_scene(S, H, W, seed=7)
    rng = np.random.default_rng(7)
    quat = rng.normal(0, 1, (1, S, 4))
    pose = np.concatenate([rng.normal(0, 0.5, (1, S, 3)),
                           quat / np.linalg.norm(quat, axis=-1, keepdims=True),
                           rng.uniform(0.8, 1.2, (1, S, 2))], -1).astype(np.float32)
    preds = {
        "images": rng.uniform(0, 1, (S, H, W, 3)).astype(np.float32),
        "pose_enc": pose,
        "depth": pts[None, ..., 2:3].copy(),
        "depth_conf": rng.uniform(1, 2, (1, S, H, W)).astype(np.float32),
        "world_points": pts[None],
        "world_points_conf": rng.uniform(1, 2, (1, S, H, W)).astype(np.float32),
        "part_feat": fts[None],
    }
    clustering = dict(eps=0.06, min_samples=20, min_cluster_size=100)
    jself = types.SimpleNamespace(runtime=JRuntimeConfig(
        clustering=JClusteringConfig(**clustering)))
    tself = types.SimpleNamespace(runtime=RuntimeConfig(clustering=ClusteringConfig(**clustering)))
    want = JProcessor._post_process(jself, dict(preds))
    trace = {}
    got = TProcessor._post_process(
        tself, {k: v if k == "images" else torch.from_numpy(v) for k, v in preds.items()},
        trace=trace)
    assert {"poses + unprojection", "PCA", "smoothing"} <= set(trace)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in got.items()}

    for k in ("extrinsic", "intrinsic", "world_points_from_depth"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert got["part_feat_pca"].shape == (S, H, W, 3)
    assert_close_up_to_flip(got["part_feat_pca"], want["part_feat_pca"])

    masks, jmasks = got["instance_masks"], want["instance_masks"]
    assert masks.shape == (S, H, W) and masks.dtype == np.int64
    n_clusters = len(np.unique(masks[masks >= 0]))
    assert n_clusters == len(np.unique(jmasks[jmasks >= 0])) >= 2
    same = masks == jmasks
    assert same.mean() >= 0.999, same.mean()
    colored = got["instance_masks_colored"]
    assert colored.shape == (S, H, W, 3) and colored.dtype == np.uint8
    np.testing.assert_array_equal(colored[same], want["instance_masks_colored"][same])


@pytest.mark.parametrize("preset", ["small", "medium", "large"])
def test_clustering_presets_match_jax(preset):
    from iggt_official_tpu.app.demo import CLUSTERING_PRESETS as JPRESETS
    from iggt_official_tpu_torch.app.demo import CLUSTERING_PRESETS as TPRESETS

    t, j = TPRESETS[preset], JPRESETS[preset]
    assert (t.eps, t.min_samples, t.min_cluster_size, t.knn_k, t.exact) == (
        j.eps, j.min_samples, j.min_cluster_size, j.knn_k, j.exact)
