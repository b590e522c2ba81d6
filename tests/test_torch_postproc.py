"""PCA colormap, Morton codes, kNN smoothing and the jet colours of the port
(CPU) against the JAX package.

Tolerances:
- PCA colours 1e-5 abs, per channel up to the eigenvector sign (a flipped
  direction maps a channel x to 1 - x in both packages' convention);
- Morton codes: equal (the same float32 operations, then integer bit ops);
- smoothed features 1e-5 abs (the same candidates and neighbours; the mean
  of 20 features sums in another order);
- jet LUT and coloured masks: equal to matplotlib's bytes.
"""

import numpy as np
import torch
import jax.numpy as jnp
from matplotlib import colormaps

import chip_smoke
from iggt_official_tpu.ops import cluster as jcluster
from iggt_official_tpu.ops import knn as jknn
from iggt_official_tpu.ops import pca as jpca
from iggt_official_tpu_torch.ops import cluster as tcluster
from iggt_official_tpu_torch.ops import knn as tknn
from iggt_official_tpu_torch.ops import pca as tpca


def assert_close_up_to_flip(got, want, atol=1e-5):
    """Per channel of the last axis: got == want or got == 1 - want."""
    for c in range(want.shape[-1]):
        g, w = got[..., c], want[..., c]
        err = min(np.abs(g - w).max(), np.abs(g - (1 - w)).max())
        assert err <= atol, (c, err)


def test_pca_colormap_matches_jax():
    rng = np.random.default_rng(0)
    # anisotropic features so the three leading directions are well separated
    feat = (rng.normal(0, 1, (2, 24, 32, 8)) * np.linspace(2, 0.2, 8)).astype(np.float32)
    got = tpca.apply_pca_colormap(torch.from_numpy(feat)).numpy()
    want = np.asarray(jpca.apply_pca_colormap(jnp.asarray(feat)))
    assert got.shape == (2, 24, 32, 3) and got.min() >= 0 and got.max() <= 1
    assert_close_up_to_flip(got, want)


def test_morton_codes_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 2, (5000, 3)).astype(np.float32)
    pts[:100] = pts[100:200]  # repeated points share a code
    got = tknn._morton_codes(torch.from_numpy(pts)).numpy()
    want = np.asarray(jknn._morton_codes(jnp.asarray(pts))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2 ** 30


def test_knn_smooth_features_matches_jax():
    """~20k-point Voronoi cloud; block=4096 runs the blocked branch (with a
    ragged last block) in both packages."""
    pts, fts = chip_smoke.voronoi_scene(2, 80, 128, seed=3)
    got = tknn.knn_smooth_features(torch.from_numpy(pts), torch.from_numpy(fts),
                                   k=20, block=4096).numpy()
    want = np.asarray(jknn.knn_smooth_features(jnp.asarray(pts), jnp.asarray(fts),
                                               k=20, block=4096))
    assert got.shape == fts.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_jet_lut_and_colorize_masks_match_matplotlib():
    # integer inputs index matplotlib's lookup table directly
    np.testing.assert_array_equal(tcluster.JET_LUT, colormaps["jet"](np.arange(256))[:, :3])
    ts = np.concatenate([np.linspace(0, 1, 1001), np.arange(37) / 36])
    np.testing.assert_array_equal((tcluster.jet(ts) * 255).astype(np.uint8),
                                  (colormaps["jet"](ts)[:, :3] * 255).astype(np.uint8))
    rng = np.random.default_rng(2)
    for n_labels in (0, 1, 2, 7, 40):
        masks = rng.integers(-1, n_labels, (3, 9, 11))
        got = tcluster.colorize_masks(masks)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jcluster.colorize_masks(masks))
