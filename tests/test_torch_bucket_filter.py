"""The bucket filter kernel's rule (`csrc/nn1.cu`, `bucket_filter_kernel`),
emulated on the CPU, against the port's plain bucket minima.

The kernel makes two passes over each bucket's chunks.  Pass 1 keeps, per
(query, bucket), the least approximation a~ = |r|^2 - 2 q.r (a1, from three
TF32 passes).  From it, the nn1 window (`ops/nn1.py::filter_constants`) gives
thr = T - |q|^2 with T = bound (1 + c u) + A_q and bound = |q|^2 + a1 + A_q,
each rounded up: any reference whose chain is at most a1's reference's has
a~ <= thr.  Pass 2 computes the exact chain of every reference with a~ <=
thr and keeps the least (chain, index).  The emulation computes a~ from the
TF32 split with the three passes accumulated in fp32 in two roundings (to
nearest and toward zero), on near ties (16 references per query within 1e-4
to 1e-3) and exact duplicates in other chunks of the same bucket.  No
tolerance: the indices must equal `bucket_minima_plain`'s; a zero window and
one TF32 pass must not.
"""

import numpy as np
import pytest
import torch

from iggt_official_tpu_torch.ops import nn1 as nn1_mod

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

NB = 64


def _tf32_rna(x):
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _round_up(x64):
    """float64 -> the least fp32 value >= it."""
    r = x64.float()
    return torch.where(r.double() < x64, torch.nextafter(r, torch.tensor(float("inf"))), r)


def _round(x64, mode):
    """float64 -> fp32 to nearest ('rn') or toward zero ('rz')."""
    r = x64.float()
    if mode == "rz":
        r = torch.where(r.double().abs() > x64.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _norm2(x):
    """|x|^2 as the kernel's fp32 FMA chain (each x_a^2 exact in float64)."""
    x = x.double()
    s = (x[:, 0] ** 2).float()
    for a in range(1, x.shape[1]):
        s = (x[:, a] ** 2 + s.double()).float()
    return s


def _approx(q, r, mode, passes=3):
    """(Q, R) fp32 a~ = fma(-2, dot, |r|^2), dot = hi.lo + lo.hi + hi.hi of the
    TF32 split (lo truncated), the 24 exact products summed in fp32 one at a
    time in `mode`."""
    qh, rh = _tf32_rna(q), _tf32_rna(r)
    ql, rl = _tf32_trunc(q - qh), _tf32_trunc(r - rh)
    pairs = ((qh, rl), (ql, rh), (qh, rh)) if passes == 3 else ((qh, rh),)
    acc = torch.zeros((q.shape[0], r.shape[0]), dtype=torch.float32)
    for a, b in pairs:
        for f in range(q.shape[1]):
            acc = _round(acc.double() + a[:, None, f].double() * b[None, :, f].double(), mode)
    return (_norm2(r).double()[None, :] - 2 * acc.double()).float()   # one FFMA rounding


def kernel_rule(q, r, nb, mode, window=None, passes=3):
    """(Q, nb) int64 indices by the kernel's rule, and the exact chains it
    computes per (query, bucket)."""
    ku, onepcu, floor = window if window is not None else nn1_mod.filter_constants()
    Q, R = q.shape[0], r.shape[0]
    chain = nn1_mod._sq_dist_block(q, r)
    approx = _approx(q, r, mode, passes)
    q2 = _norm2(q).double()
    max_r2 = _norm2(r).double().max()
    aq = _round_up(_round_up(ku * _round_up(q2 + max_r2).double()).double() + floor).double()
    out = torch.empty((Q, nb), dtype=torch.int64)
    rechecks = 0
    for b in range(nb):
        cols = torch.arange(b, R, nb)
        if len(cols) == 0:
            out[:, b] = b
            continue
        a = approx[:, cols].double()
        a1 = a.min(dim=1).values                                   # pass 1
        bound = _round_up(_round_up(q2 + a1).double() + aq).double()
        thr = _round_up(_round_up(_round_up(bound * onepcu).double() + aq).double() - q2).double()
        cand = ~(a > thr[:, None])                                 # pass 2 (NaN passes)
        rechecks += int(cand.sum())
        d = torch.where(cand, chain[:, cols], torch.tensor(float("inf")))
        j = torch.argmin(d, dim=1)                                 # first on ties
        out[:, b] = torch.where(cand.any(dim=1), cols[j], torch.tensor(b))
    return out, rechecks


def _near_tie_data(seed=11, nq=48, k=16, n_other=400):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (nq, 8))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(nq, k, 8))
    v /= np.linalg.norm(v, axis=2, keepdims=True)
    planted = (q[:, None, :] + rng.uniform(1e-4, 1e-3, (nq, k, 1)) * v).reshape(-1, 8)
    other = rng.normal(0, 1, (n_other, 8))
    other /= np.linalg.norm(other, axis=1, keepdims=True)
    r = np.concatenate([planted, other])[rng.permutation(nq * k + n_other)].astype(np.float32)
    # exact duplicates in later chunks of the same bucket, and queries on them
    for b in range(0, 40, 3):
        r[b + 7 * NB] = r[b + 2 * NB]
    q = q.astype(np.float32)
    q[:6] = r[[2 * NB, 2 * NB + 3, 2 * NB + 6, 7 * NB, 5, 9]]
    return torch.from_numpy(q), torch.from_numpy(r)


@pytest.mark.parametrize("mode", ["rn", "rz"])
def test_bucket_rule_gives_the_plain_indices_on_near_ties(mode):
    """Equal indices, and the rechecks stay near one per (query, bucket):
    the window holds the near ties, not whole buckets."""
    q, r = _near_tie_data()
    want = nn1_mod.bucket_minima_plain(q, r, NB)[1]
    got, rechecks = kernel_rule(q, r, NB, mode)
    assert torch.equal(got, want)
    assert q.shape[0] * NB <= rechecks < 1.5 * q.shape[0] * NB


@pytest.mark.parametrize("fault", ["window zero", "one TF32 pass"])
def test_bucket_rule_faults_mismatch(fault):
    """The kernel's planted faults, as `_filter_args` hands them over."""
    q, r = _near_tie_data()
    want = nn1_mod.bucket_minima_plain(q, r, NB)[1]
    ku, onepcu, floor, passes = nn1_mod._filter_args(fault)
    got, _ = kernel_rule(q, r, NB, "rn", window=(ku, onepcu, floor), passes=passes)
    assert (got != want).sum() > 0
