"""The fp32 flash kernel's arithmetic (`csrc/flash_attention.cu`,
`flash_kernel_tf32`), emulated on the CPU, against the port's plain version.

The kernel splits every fp32 operand x into hi = cvt.rna.tf32(x) and lo =
x - hi (exact in fp32), which the tensor core reads truncated to TF32, and
runs S = Q.K^T and O += P.V as three TF32 passes (hi.lo + lo.hi + hi.hi);
P = 2^(s - m) is split the same way in registers.  Each tile's P.V comes
fresh from the tensor cores and is added to O in fp32.  P goes from the S
accumulator layout to the A operand of P.V without a shuffle because V^T is
stored with the keys of every group of 8 permuted; the emulation builds the
A operand from the accumulator layout and permutes V^T as the prep kernel
does.  The tensor core's sums are modelled as exact sums rounded once to
fp32 per tile (the kernel keeps the running O out of the tensor core for
that reason).  Tolerance: 1e-5 abs, the card check's; one TF32 pass and an
unpermuted V^T must exceed it.
"""

import math

import numpy as np
import pytest
import torch

from iggt_official_tpu_torch.layers.rope import (
    compute_rope_2d, make_patch_positions, pack_rope_tables,
)
from iggt_official_tpu_torch.ops import flash_attention as fa

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

FP32_ABS = 1e-5
BK = 64                                          # keys per tile
LOG2E = 1.4426950408889634
# V^T position kk of every group of 8 keys holds key PERM[kk]: the S
# accumulator gives a thread keys 2t and 2t + 1, the TF32 A fragment asks for
# k-columns t and t + 4
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_rna(x):
    """fp32 rounded to the nearest TF32 value, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """fp32 truncated to TF32 (how the tensor core reads a lo part)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """(hi, lo as the tensor core reads it)."""
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _tc(a, b, passes, eq):
    """A TF32 product of split operands on the tensor core: the exact sum of
    the passes' products, rounded once to fp32."""
    (ah, al), (bh, bl) = a, b
    terms = ((ah, bl), (al, bh), (ah, bh)) if passes == 3 else ((ah, bh),)
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in terms).float()


def _a_fragment_columns(n):
    """The key each k-column of the P.V A operand holds, tile of n keys: the
    S accumulator's element d[4j + e] is (row g, key 8j + 2t + e); the kernel
    packs a = {d[4c], d[4c + 2], d[4c + 1], d[4c + 3]}, and a0 / a1 are
    k-column t, a2 / a3 k-column t + 4."""
    cols = torch.empty(n, dtype=torch.long)
    for c in range(n // 8):
        for t in range(4):
            cols[8 * c + t] = 8 * c + 2 * t            # a0 / a1 <- d[4c] / d[4c + 2]
            cols[8 * c + t + 4] = 8 * c + 2 * t + 1    # a2 / a3 <- d[4c + 1] / d[4c + 3]
    return cols


def emulate(q, k, v, key_bias=None, passes=3, permute=True):
    """The kernel's fp32 path on (B, N, H, D) fp32 tensors (q and k already
    prepped when the call is fused)."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    nk_pad = -(-Nk // BK) * BK
    pad = nk_pad - Nk
    qs = _split(q.permute(0, 2, 1, 3))                       # (B, H, Nq, D)
    ks = _split(torch.nn.functional.pad(k.permute(0, 2, 1, 3), (0, 0, 0, pad)))
    vt = torch.nn.functional.pad(v.permute(0, 2, 3, 1), (0, pad))   # V^T (B, H, D, Nk_pad)
    if permute:                                              # as the prep kernel writes it
        perm = (torch.arange(nk_pad) // 8 * 8) + torch.tensor(PERM).repeat(nk_pad // 8)
        vt = vt[..., perm]
    vts = _split(vt)
    cols = _a_fragment_columns(BK)
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, H, Nq, 1), -1e30)
    l = torch.zeros((B, H, Nq, 1))
    o = torch.zeros((B, H, Nq, D))
    for k0 in range(0, Nk, BK):
        s = _tc(qs, tuple(x[:, :, k0:k0 + BK] for x in ks), passes, "bhqd,bhkd->bhqk")
        s = s * torch.tensor(scale * LOG2E, dtype=torch.float32)
        if key_bias is not None:
            kb = torch.nn.functional.pad(key_bias, (0, pad))[:, None, None, k0:k0 + BK]
            s = s + kb * torch.tensor(LOG2E, dtype=torch.float32)
        key = torch.arange(k0, k0 + BK)
        s = torch.where(key < Nk, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        pa = p[..., cols]                                    # the A operand's k-columns
        pv = _tc(_split(pa), tuple(x[..., k0:k0 + BK] for x in vts), passes,
                 "bhqk,bhdk->bhqd")
        o = o * alpha + pv
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _inputs(B, N, H, D, seed, bias, prep):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, N, H, D)).astype(np.float32))
               for _ in range(3))
    kb = torch.from_numpy(rng.normal(0, 1, (B, N)).astype(np.float32)) if bias else None
    if prep:
        side = math.isqrt(N - 5)
        pos = make_patch_positions(side, side, B, N - side * side).reshape(B, N, 2)
        cos, sin = pack_rope_tables(compute_rope_2d(pos, D))
        norm = [torch.from_numpy((rng.normal(0, 0.5, D) + c).astype(np.float32))
                for c in (1.0, 0.0, 1.0, 0.0)]
        q = fa.qk_prep_plain(q, norm[0], norm[1], cos, sin)
        k = fa.qk_prep_plain(k, norm[2], norm[3], cos, sin)
    return q, k, v, kb


CASES = [(2, 200, 2, 32), (1, 149, 2, 64)]   # the part head's D; the trunk's D, 5 + 12^2 tokens


@pytest.mark.parametrize("prep", [False, True], ids=["plain", "ln+rope"])
@pytest.mark.parametrize("bias", [False, True], ids=["no bias", "bias"])
@pytest.mark.parametrize("shape", CASES, ids=["D32", "D64"])
def test_three_tf32_passes_hold_the_fp32_limit(shape, bias, prep):
    q, k, v, kb = _inputs(*shape, seed=sum(shape), bias=bias, prep=prep)
    ref = fa.flash_attention_plain(q, k, v, kb)
    err = (emulate(q, k, v, kb) - ref).abs().max().item()
    assert err <= FP32_ABS, err


@pytest.mark.parametrize("fault", ["one TF32 pass", "V^T without the key permutation"])
def test_planted_faults_exceed_the_limit(fault):
    q, k, v, kb = _inputs(1, 149, 2, 64, seed=3, bias=True, prep=True)
    ref = fa.flash_attention_plain(q, k, v, kb)
    kw = {"passes": 1} if fault == "one TF32 pass" else {"permute": False}
    err = (emulate(q, k, v, kb, **kw) - ref).abs().max().item()
    assert err > 10 * FP32_ABS, err
    assert fault in fa.FP32_FAULTS


def test_the_split_is_exact_and_the_permutation_a_bijection():
    """hi + lo == x for the split the prep kernel writes (lo before the tensor
    core truncates it), and the A operand's columns, read through PERM,
    give back the keys in order."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 4096).astype(np.float32))
    hi = _tf32_rna(x)
    assert torch.equal(hi + (x - hi), x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    cols = _a_fragment_columns(BK)
    # the A operand's k-column kk holds key PERM[kk] of its group, where the
    # prep kernel puts that key's V^T column
    assert cols[:8].tolist() == list(PERM)
    assert sorted(cols.tolist()) == list(range(BK))
