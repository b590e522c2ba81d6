"""The port's 1-NN search and bucket top-k (plain paths, CPU) against the JAX
package's Pallas kernels in interpret mode and against numpy brute force.

Tolerance: none on indices.  Both sides sum the squared differences of the 8
features in the same order with every operation rounded on its own, and
break ties to the smallest reference index (bucket top-k: inside a bucket;
between buckets by bucket position), so the indices must be equal.  Bucket
top-k distances equal numpy's sequential fp32 chain with a correctly rounded
sqrt; against the JAX package they agree to 1e-6 relative, not bit for bit,
because XLA:CPU contracts the interpret-mode multiply-add into an FMA (one
rounding instead of two).  The CUDA kernels are held to the plain versions
on the card (`test_torch_kernels.py`).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iggt_official_tpu.ops.nn1_pallas import bucket_topk_pallas, nn1_pallas
from iggt_official_tpu_torch.ops.nn1 import bucket_minima_kernel, bucket_topk, nn1, nn1_plain


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


def _chain_dist(qry, ref, idx):
    """Distances of the returned pairs by the sequential fp32 chain, sqrt
    correctly rounded (numpy's)."""
    d = np.zeros(idx.shape, np.float32)
    for a in range(qry.shape[1]):
        diff = qry[:, None, a] - ref[idx, a]
        d = d + diff * diff
    return np.sqrt(d)


def _bucket_case(qry, ref, k, nb):
    launches = bucket_minima_kernel.launches
    dist, idx = bucket_topk(torch.from_numpy(qry), torch.from_numpy(ref), k, nb)
    assert bucket_minima_kernel.launches == launches  # CPU tensors never launch the kernel
    jd, ji = bucket_topk_pallas(jnp.asarray(qry), jnp.asarray(ref), k, nb=nb, interpret=True)
    assert idx.dtype == torch.int64 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(dist.numpy(), _chain_dist(qry, ref, idx.numpy()))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    return dist.numpy(), idx.numpy()


def test_bucket_topk_matches_pallas():
    """The oracle's case (tests/test_cluster_device.py): 3,000 clustered
    points against themselves, k = 16, nb = 1024 (two JAX ref blocks)."""
    pts = _blobs(np.random.default_rng(3), 3000)
    dist, idx = _bucket_case(pts, pts, 16, 1024)
    assert (idx[:, 0] == np.arange(3000)).all() and (dist[:, 0] == 0).all()
    assert (np.diff(dist, axis=1) >= 0).all()


def test_bucket_topk_ties():
    """Duplicated references inside one bucket (the smaller index wins) and
    in two buckets (the lower bucket position comes first), nb = 64 with a
    ragged last row of references."""
    rng = np.random.default_rng(4)
    ref = _blobs(rng, 1000)
    ref[640:650] = ref[0:10]        # 640 = 10 * 64: same buckets as 0..9
    ref[500:510] = ref[20:30]       # buckets 52..61 vs 20..29
    qry = np.concatenate([ref[:40], _blobs(rng, 200)])
    dist, idx = _bucket_case(qry, ref, 8, 64)
    np.testing.assert_array_equal(idx[:10, 0], np.arange(10))
    np.testing.assert_array_equal(idx[20:30, :2], np.stack([np.arange(20, 30),
                                                            np.arange(500, 510)], 1))
