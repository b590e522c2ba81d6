"""The port's per-view clustering, weighted DBSCAN and exact-graph smoothing
(`ops/cluster.py::weighted_dbscan`, `::cluster_features_to_masks`,
`ops/knn.py::knn_smooth_features_exact`) against the JAX package's, on the CPU.

Inputs are seeded Gaussian blobs and `chip_smoke.voronoi_scene` scenes.
Labels and masks must be equal (both packages run the same native C++ code
or its reference semantics); the exact smoothing within 1e-6 (a mean of the
same neighbours' fp32 features, summed in the same order).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from iggt_official_tpu.ops import cluster as jcl
from iggt_official_tpu.ops import knn as jknn
from iggt_official_tpu_torch.ops import cluster as tcl
from iggt_official_tpu_torch.ops.knn import knn_smooth_features_exact

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)


@pytest.mark.parametrize("eps,min_samples", [(0.15, 8), (0.08, 20)])
def test_weighted_dbscan_matches_jax(eps, min_samples):
    """Weighted cells (weights 1-6) around six centres plus uniform noise:
    core merging, border assignment and noise equal to the JAX package's."""
    rng = np.random.default_rng(min_samples)
    centers = rng.normal(0, 1, (6, 8)).astype(np.float32)
    pts = np.concatenate([centers[rng.integers(0, 6, 1500)]
                          + rng.normal(0, 0.05, (1500, 8)).astype(np.float32),
                          rng.uniform(-2, 2, (200, 8)).astype(np.float32)])
    weights = rng.integers(1, 7, len(pts))
    got = tcl.weighted_dbscan(pts, weights, eps, min_samples)
    want = jcl.weighted_dbscan(pts, weights, eps, min_samples)
    assert got.dtype == np.int64 and (got == -1).any() and got.max() >= 1
    np.testing.assert_array_equal(got, want)


def test_cluster_features_to_masks_dbscan_matches_jax():
    """Per-view "dbscan" masks and colours of a 2-view Voronoi scene, numpy
    in and a CPU tensor in."""
    _, fts = chip_smoke.voronoi_scene(2, 24, 32, seed=4)
    kw = dict(method="dbscan", eps=0.06, min_samples=10, min_cluster_size=40)
    want, want_rgb = jcl.cluster_features_to_masks(fts, apply_colormap=True, **kw)
    got, got_rgb = tcl.cluster_features_to_masks(fts, apply_colormap=True, **kw)
    assert got.shape == (2, 24, 32) and len(np.unique(got)) > 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    np.testing.assert_array_equal(
        tcl.cluster_features_to_masks(torch.from_numpy(fts), **kw), want)
    with pytest.raises(ValueError, match="unknown method"):
        tcl.cluster_features_to_masks(fts, method="spectral")


def test_knn_smooth_features_exact_matches_jax():
    """The exact kNN graph (self excluded) over a 2-view cloud with duplicate
    points, at k = 20 and at k past the cloud's size."""
    pts, fts = chip_smoke.voronoi_scene(2, 16, 20, seed=5)
    pts = pts.copy()
    pts[0, :2] = pts[0, 2:4]                     # duplicated points
    for k in (20, 700):
        want = jknn.knn_smooth_features_exact(pts, fts, k=k)
        got = knn_smooth_features_exact(torch.from_numpy(pts), torch.from_numpy(fts), k=k)
        assert got.shape == fts.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
