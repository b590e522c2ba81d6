"""The port's 1-NN search (plain path, CPU) against the JAX package's Pallas
kernel in interpret mode and against numpy brute force.

Tolerance: none.  Both sides sum the squared differences of the 8 features in
the same order with every operation rounded on its own, and break ties to the
smallest reference index, so the indices must be equal.  The CUDA kernel is
held to the plain version on the card (`test_torch_kernels.py`).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iggt_official_tpu.ops.nn1_pallas import nn1_pallas
from iggt_official_tpu_torch.ops.nn1 import nn1, nn1_plain


def _blobs(rng, n, d=8, k_inst=6, sigma=0.05):
    centers = rng.normal(0, 1, (k_inst, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, k_inst, n)
    return (centers[lab] + rng.normal(0, sigma, (n, d))).astype(np.float32)


def _brute(qry, ref):
    """Sequential-order fp32 squared distances, first arg-min."""
    d = np.zeros((qry.shape[0], ref.shape[0]), np.float32)
    for a in range(qry.shape[1]):
        diff = qry[:, None, a] - ref[None, :, a]
        d = d + diff * diff
    return d.argmin(axis=1)


def test_nn1_matches_pallas_with_ties():
    """The tie data of tests/test_cluster_device.py: 30 duplicated refs and
    50 queries that hit a ref exactly."""
    rng = np.random.default_rng(0)
    ref = _blobs(rng, 700)
    ref[350:380] = ref[0:30]
    qry = _blobs(rng, 900)
    qry[:50] = ref[10:60]
    launches = nn1.launches
    out = nn1(torch.from_numpy(qry), torch.from_numpy(ref))
    want = np.asarray(nn1_pallas(jnp.asarray(qry), jnp.asarray(ref), interpret=True))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), _brute(qry, ref))
    # queries 0..19 hit refs 10..29, duplicated at 360..379: the lower index
    np.testing.assert_array_equal(out.numpy()[:20], np.arange(10, 30))
    assert nn1.launches == launches  # CPU tensors never launch the kernel


def test_nn1_ragged_two_ref_blocks():
    """1,000 x 2,500: two JAX ref blocks of 2,048, the second ragged; the
    plain version's query blocks ragged too."""
    rng = np.random.default_rng(1)
    ref = rng.normal(0, 1, (2500, 8)).astype(np.float32)
    qry = rng.normal(0, 1, (1000, 8)).astype(np.float32)
    want = _brute(qry, ref)
    np.testing.assert_array_equal(
        nn1_plain(torch.from_numpy(qry), torch.from_numpy(ref), block_q=384).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(nn1_pallas(jnp.asarray(qry), jnp.asarray(ref), interpret=True)), want)


def test_nn1_edge_cases():
    rng = np.random.default_rng(2)
    ref = torch.from_numpy(rng.normal(0, 1, (5, 8)).astype(np.float32))
    assert nn1(torch.zeros((0, 8)), ref).shape == (0,)
    assert nn1(ref, ref[:1]).tolist() == [0] * 5
    assert nn1(ref[3:4], ref).tolist() == [3]
    with pytest.raises(ValueError, match="reference row"):
        nn1(ref, ref[:0])
    with pytest.raises(ValueError, match="expected"):
        nn1(ref, ref[:, :4])
