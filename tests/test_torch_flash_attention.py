"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's wrappers take their plain versions; these are held to
JAX's `attention` / `sdpa_chunked` and to the fused Pallas kernel run in
interpret mode.  The CUDA kernels are held to the plain versions in
`test_torch_kernels.py`, on the card.

Tolerances: fp32 1e-5 abs (same math, summation order differs).  bf16
2e-2 abs, about 1% of the outputs here (max |ref| is 0.9 to 2.7 with at most
45 keys; the errors seen are 0.4-1.0% of it): the JAX CPU path rounds the logits to bf16 before
its fp32 softmax and the Pallas kernel rounds the unnormalized probabilities,
where the port keeps fp32 logits and rounds normalized ones; a bf16 ulp near
1 is 2^-8.
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iggt_official_tpu.layers import rope as jrope
from iggt_official_tpu_torch.layers import rope as trope
from iggt_official_tpu_torch.ops import flash_attention as tfa

# the JAX ops package re-exports a function of the module's name
jfa = importlib.import_module("iggt_official_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Nq, Nk, H, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32) for n in (Nq, Nk, Nk))
    bias = rng.standard_normal((B, Nk)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    # round once in torch so both packages see identical bf16 values
    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    j = [jnp.asarray(x.float().numpy()).astype(jdt) for x in t]
    return t, j, bias


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_matches_jax(dtype, D, with_bias):
    """N not a multiple of any block; Nq != Nk for the cross-attention shape."""
    (q, k, v), (jq, jk, jv), bias = _inputs(0, 2, 37, 45, 2, D, dtype)
    tb = torch.from_numpy(bias) if with_bias else None
    jb = jnp.asarray(bias) if with_bias else None
    out = tfa.attention(q, k, v, key_bias=tb)
    ref = jfa.attention(jq, jk, jv, key_bias=jb)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=0)
    # the blockwise plain version with a block that does not divide N
    out_b = tfa.flash_attention_plain(q, k, v, tb, block_q=16)
    ref_b = jfa.sdpa_chunked(jq, jk, jv, jb, block_q=16)
    np.testing.assert_allclose(_np(out_b), _np(ref_b), atol=TOL[dtype], rtol=0)
    np.testing.assert_array_equal(_np(out_b), _np(out))


def _rope(B, grid, psi, D):
    tpos = trope.make_patch_positions(grid, grid, B, psi)
    tcos, tsin = trope.pack_rope_tables(trope.compute_rope_2d(tpos, D))
    jpos = jrope.make_patch_positions(grid, grid, B, psi)
    jcos, jsin = jrope.pack_rope_tables(jrope.compute_rope_2d(jpos, D))
    return (tcos, tsin), (jcos, jsin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64])
def test_fused_prep_matches_pallas_interpret(dtype, D):
    """Port fused path == the Pallas fused kernel (interpret mode): norm +
    rope + key bias everywhere, and norm + rope, rope only, norm only in
    fp32 at D=64; N = 5 + 25 tokens."""
    B, H, N = 2, 2, 30
    (q, k, v), (jq, jk, jv), bias = _inputs(1, B, N, N, H, D, dtype)
    (tcos, tsin), (jcos, jsin) = _rope(B, 5, 5, D)
    rng = np.random.default_rng(2)
    norm = [rng.standard_normal(D).astype(np.float32) * 0.5 + c for c in (1, 0, 1, 0)]
    tnorm = [torch.from_numpy(x) for x in norm]
    jnorm = tuple(jnp.asarray(x) for x in norm)
    combos = [(True, True, True)]
    if (dtype, D) == ("float32", 64):
        combos += [(True, True, False), (False, True, False), (True, False, False)]
    for use_norm, use_rope, use_bias in combos:
        out = tfa.flash_attention_fused(
            q, k, v, tcos if use_rope else None, tsin if use_rope else None,
            tnorm if use_norm else None, torch.from_numpy(bias) if use_bias else None)
        ref = jfa.flash_attention_fused(
            jq, jk, jv, jcos if use_rope else None, jsin if use_rope else None,
            jnorm if use_norm else None, jnp.asarray(bias) if use_bias else None,
            interpret=True)
        np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype], rtol=0,
                                   err_msg=f"norm={use_norm} rope={use_rope} bias={use_bias}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_prep_plain_matches_xla(dtype):
    """fp32 LN + RoPE with one rounding: identical up to fp32 rounding, so
    bf16 outputs may differ by one bf16 ulp (2^-8 relative)."""
    (q, _, _), (jq, _, _), _ = _inputs(3, 2, 30, 30, 2, 64, dtype)
    (tcos, tsin), (jcos, jsin) = _rope(2, 5, 5, 64)
    g, b = torch.linspace(0.5, 1.5, 64), torch.linspace(-0.2, 0.2, 64)
    out = tfa.qk_prep_plain(q, g, b, tcos, tsin)
    ref = jfa._qk_prep_xla(jq, jnp.asarray(g.numpy()), jnp.asarray(b.numpy()), jcos, jsin,
                           1e-5)
    assert out.dtype == q.dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_dispatch_routes_and_counts():
    """`attention` with the prep (the frame and global blocks' route) goes to
    the fused wrapper (on the CPU: plain prep + plain flash) and equals JAX
    `attention_fused` on the CPU, and CPU calls launch no kernel (the
    counters stay put)."""
    (q, k, v), (jq, jk, jv), _ = _inputs(4, 1, 60, 60, 2, 64, "float32")
    pos_t = trope.make_patch_positions(5, 11, 1, 5)
    tcos, tsin = trope.pack_rope_tables(trope.compute_rope_2d(pos_t, 64))
    pos_j = jrope.make_patch_positions(5, 11, 1, 5)
    jcos, jsin = jrope.pack_rope_tables(jrope.compute_rope_2d(pos_j, 64))
    norm = [torch.full((64,), 1.1), torch.full((64,), 0.1),
            torch.full((64,), 0.9), torch.full((64,), -0.1)]
    before = (tfa.flash_attention.launches, tfa.flash_attention_fused.launches)
    ref = jfa.attention_fused(jq, jk, jv, jcos, jsin,
                              tuple(jnp.asarray(x.numpy()) for x in norm))
    assert tfa.attention.supports_fused_qk_prep
    out = tfa.attention(q, k, v, rope_cos=tcos, rope_sin=tsin, qk_norm_params=norm)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=0)
    assert (tfa.flash_attention.launches, tfa.flash_attention_fused.launches) == before


def test_wrappers_reject_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 1, 48)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._launch(q, q, q)
