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
from iggt_official_tpu_torch.ops import nn1 as nn1_mod
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


# ---------------------------------------------------------------------------
# The nn1 kernel's recheck window (csrc/nn1.cu), emulated on the CPU: the TF32
# split, the three-pass dot accumulated in fp32 in several orders and
# roundings, the fp32 norms and the FFMA.  The kernel is exact if the
# approximation |q|^2 + a~ of every pair lies within the window of the exact
# chain; the derivation gives 102.5 U (|q|^2 + max|r|^2) against the true
# distance, and the window allows KAPPA = 256 of those units.

def _tf32_rna(x):
    """fp32 rounded to the nearest TF32 value, ties away from zero
    (cvt.rna.tf32.f32), by integer bit operations."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """fp32 truncated to TF32 (how the tensor core reads the low part)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _rz(x64):
    """float64 -> fp32 rounded toward zero."""
    r = x64.float()
    over = r.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _fma_norm2(x):
    """|x|^2 as the kernel's fp32 FMA chain (x_a^2 is exact in float64)."""
    x = x.double()
    s = x[:, 0] ** 2
    s = s.float().double()
    for a in range(1, x.shape[1]):
        s = (x[:, a] ** 2 + s).float().double()
    return s


def _block_trunc(acc, terms):
    """One tensor-core block: every term (the accumulator included) aligned to
    the largest with the bits below its last place truncated, the exact sum
    of those, truncated to fp32."""
    allt = torch.cat([acc[..., None], terms], -1)
    e = torch.frexp(allt.abs().amax(-1, keepdim=True).float())[1].double()
    ulp = torch.exp2(e - 24)
    aligned = torch.trunc(allt / ulp) * ulp
    return _rz(aligned.sum(-1)).double()


def _three_pass_dots(q, r, order, mode):
    """(Q, R) fp32 dots of hi.lo + lo.hi + hi.hi, accumulated in fp32 as
    `mode` says: 'rn' / 'rz' one product at a time, 'blocks' in the
    aligned-and-truncated blocks of 4 products."""
    qh, rh = _tf32_rna(q), _tf32_rna(r)
    ql, rl = _tf32_trunc(q - qh), _tf32_trunc(r - rh)
    passes = {"hl": (qh, rl), "lh": (ql, rh), "hh": (qh, rh)}
    prods = torch.cat([passes[p][0].double()[:, None, :] * passes[p][1].double()[None, :, :]
                       for p in order], -1)                       # (Q, R, 24), exact
    acc = torch.zeros(prods.shape[:2], dtype=torch.float64)
    if mode == "blocks":
        for k in range(0, prods.shape[-1], 4):
            acc = _block_trunc(acc, prods[..., k:k + 4])
        return acc
    for k in range(prods.shape[-1]):
        s = acc + prods[..., k]
        acc = (_rz(s) if mode == "rz" else s.float()).double()
    return acc


def _window_case(q, r):
    """Largest |(|q|^2 + a~) - d2_chain| over every order and rounding, and
    A_q = window - best c U of each query (as the wrapper hands it to the
    kernel), both float64 (Q, R)."""
    q2, r2 = _fma_norm2(q), _fma_norm2(r)
    max_r2 = r2.max()
    chain = nn1_mod._sq_dist_block(q, r).double()
    worst = torch.zeros_like(chain)
    for order in (("hl", "lh", "hh"), ("hh", "lh", "hl")):
        for mode in ("rn", "rz", "blocks"):
            dot = _three_pass_dots(q, r, order, mode)
            a = (r2[None, :] - 2 * dot).float().double()        # one FFMA rounding
            worst = torch.maximum(worst, (q2[:, None] + a - chain).abs())
    best = chain.min(1, keepdim=True).values
    ku, onepcu, floor = nn1_mod.filter_constants()
    # T = best (1 + c U) + A_q, A_q = kappa U (|q|^2 + max |r|^2) + F
    window = best * onepcu + (ku * (q2[:, None] + max_r2) + floor) - best
    a_q = window - best * nn1_mod.C_CHAIN * nn1_mod.U
    derived = (102.5 * nn1_mod.U * (q2[:, None] + max_r2) + 10.02 * nn1_mod.U * chain
               + 2.0 ** -119)
    return worst, a_q, derived


def _unit(rng, n, d=8):
    x = _blobs(rng, n, d)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _near_ties(rng, nq=48, k=16, n_other=400):
    q = _unit(rng, nq)
    v = rng.normal(size=(nq, k, 8))
    v /= np.linalg.norm(v, axis=2, keepdims=True)
    eps = rng.uniform(1e-4, 1e-3, (nq, k, 1))
    planted = (q[:, None, :] + eps * v).reshape(-1, 8)
    ref = np.concatenate([planted, _unit(rng, n_other)])
    return q, ref[rng.permutation(len(ref))]


@pytest.mark.parametrize("case", ["unit", "near ties", "norm 1e-3", "norm 1e3", "mixed norms"])
def test_nn1_recheck_window_holds_for_emulated_tensor_core_sums(case):
    """|(|q|^2 + a~) - d2_chain| <= A_q / 2 for every pair, under every
    emulated accumulation; and within the derivation's own bound."""
    rng = np.random.default_rng(11)
    if case == "near ties":
        q, r = _near_ties(rng)
    else:
        q, r = _unit(rng, 48), _unit(rng, 640)
        if case != "unit":
            scale = {"norm 1e-3": 1e-3, "norm 1e3": 1e3}.get(case)
            if scale is None:
                sq = rng.choice([1e-3, 1.0, 1e3], (48, 1))
                sr = rng.choice([1e-3, 1.0, 1e3], (640, 1))
            else:
                sq = sr = scale
            q, r = q * sq, r * sr
    q = torch.from_numpy(q.astype(np.float32))
    r = torch.from_numpy(r.astype(np.float32))
    worst, a_q, derived = _window_case(q, r)
    assert (worst <= a_q / 2).all(), (worst / a_q).max().item()
    assert (worst <= derived).all(), (worst / derived).max().item()
    # the window is not vacuous: the approximation does err
    assert worst.max() > 0


def test_nn1_kernel_gets_the_tested_window():
    """`_launch` hands the kernel `filter_constants()` (the window the test
    above checks) with three passes; each constant is exact in fp32, as the
    kernel receives it; the planted faults change exactly what they name."""
    ku, onepcu, floor = nn1_mod.filter_constants()
    assert nn1_mod._filter_args() == (ku, onepcu, floor, 3)
    assert (ku, onepcu, floor) == (nn1_mod.KAPPA * nn1_mod.U, 1 + nn1_mod.C_CHAIN * nn1_mod.U,
                                   nn1_mod.FLOOR)
    assert all(float(np.float32(x)) == x for x in (ku, onepcu, floor))
    assert nn1_mod.KAPPA >= 2 * 102.5 and nn1_mod.C_CHAIN >= 2 * 10.02
    assert nn1_mod._filter_args("window zero") == (0.0, 1.0, 0.0, 3)
    assert nn1_mod._filter_args("one TF32 pass") == (ku, onepcu, floor, 1)
