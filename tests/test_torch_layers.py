"""Trunk layers of the PyTorch port against the JAX package.

Same inputs (numpy seeds) and the same weights (made by the port, carried to
JAX with its converter) through both packages.  Tolerances: fp32 modules
1e-4 relative to the output's magnitude (both compute in fp32; only the
summation order differs, errors seen are ~1e-6); bf16 blocks 3e-2 relative
(bf16 has 8 mantissa bits and the two frameworks round matmul outputs,
biases and logits at different points).
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from iggt_official_tpu.config import ViTConfig as JViTConfig
from iggt_official_tpu.layers import blocks as jblocks
from iggt_official_tpu.layers import rope as jrope
from iggt_official_tpu.layers.vit import DinoViT as JDinoViT
from iggt_official_tpu.ops import interpolate as jinterp
from iggt_official_tpu_torch.config import ViTConfig
from iggt_official_tpu_torch.layers import blocks as tblocks
from iggt_official_tpu_torch.layers import rope as trope
from iggt_official_tpu_torch.layers.vit import DinoViT
from iggt_official_tpu_torch.ops import flash_attention as tfa
from iggt_official_tpu_torch.ops import interpolate as tinterp

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

jfa = importlib.import_module("iggt_official_tpu.ops.flash_attention")


def test_rope_tables_and_application_match_jax():
    tpos = trope.make_patch_positions(3, 4, 2, 5)
    jpos = jrope.make_patch_positions(3, 4, 2, 5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    tt = trope.compute_rope_2d(tpos, 32, 100.0)
    jt = jrope.compute_rope_2d(jpos, 32, 100.0)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    for a, b in zip(trope.pack_rope_tables(tt), jrope.pack_rope_tables(jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    x = np.random.default_rng(0).standard_normal((2, 17, 3, 32)).astype(np.float32)
    out = trope.apply_rope_2d(torch.from_numpy(x), tt)
    ref = jrope.apply_rope_2d(jnp.asarray(x), jt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_head_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 9, 3, 64)) * 3 + 2).astype(np.float32)
    ln = tblocks.HeadLayerNorm(64)
    sd = load_numpy(ln, perturbed_state_dict(ln, 2)).state_dict()
    params = {"params": {"scale": sd["weight"].numpy(), "bias": sd["bias"].numpy()}}
    ref = jblocks.HeadLayerNorm(64).apply(params, jnp.asarray(x))
    out = ln(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_fast_variance_matches_flax(dtype):
    """The pre-norm LayerNorm: flax's var = max(E[x^2] - mu^2, 0) in fp32 and
    y = (x - mu) * (rsqrt(var + eps) * weight) + bias, fp32 out for bf16 in."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 7, 256)) + 3.0).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    ln = tblocks.LayerNorm(256, eps=1e-6)
    sd = load_numpy(ln, perturbed_state_dict(ln, 4)).state_dict()
    params = {"params": {"scale": sd["weight"].numpy(), "bias": sd["bias"].numpy()}}
    ref = np.asarray(fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32).apply(params, xj))
    out = ln(xt).detach().numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_block_with_qk_norm_and_rope_matches_jax(dtype, tol):
    """An aggregator block (qk-norm + 2D RoPE through the fused-prep protocol)."""
    B, grid, psi, C, H = 2, 4, 5, 128, 2
    N = psi + grid * grid
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    blk = tblocks.Block(C, H, init_values=0.01, qk_norm=True, dtype=getattr(torch, dtype),
                        attn_fn=tfa.attention)
    sd = perturbed_state_dict(blk, 6)
    load_numpy(blk, sd)
    tpos = trope.make_patch_positions(grid, grid, B, psi)
    jpos = jrope.make_patch_positions(grid, grid, B, psi)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jblk = jblocks.Block(C, H, init_values=0.01, qk_norm=True, dtype=getattr(jnp, dtype),
                         attn_fn=jfa.attention)
    ref = jit(jblk.apply)(to_flax(sd), jnp.asarray(xt.float().numpy()).astype(
        getattr(jnp, dtype)), jrope.compute_rope_2d(jpos, C // H))
    with torch.inference_mode():
        out = blk(xt, trope.compute_rope_2d(tpos, C // H))
    assert out.dtype == xt.dtype
    assert rel_err(ref, out.float().numpy()) < tol


def test_attention_prep_needs_a_fused_attn_fn():
    """qk-norm / RoPE reach raw q/k only through an attn_fn of the fused-prep
    protocol; a plain attn_fn is never given unprepped q/k: the module preps
    them first (the JAX package's unfused branch), so in fp32 both routes
    give the same attention."""
    B, grid, psi, C, H = 1, 3, 5, 64, 2
    attn = tblocks.Attention(C, H, qk_norm=True, attn_fn=tblocks.sdpa_plain)
    load_numpy(attn, perturbed_state_dict(attn, 11))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, psi + grid * grid, C)).astype(np.float32))
    rope = trope.compute_rope_2d(trope.make_patch_positions(grid, grid, B, psi), C // H)
    with torch.inference_mode():
        plain = attn(x, rope)
        fused = attn(x, rope, attn_fn=tfa.attention)
        unprepped = tblocks.Attention(C, H, attn_fn=tblocks.sdpa_plain)
        unprepped.load_state_dict(attn.state_dict(), strict=False)
        raw = unprepped(x)
    assert plain.shape == (B, psi + grid * grid, C)
    np.testing.assert_allclose(plain.numpy(), fused.numpy(), rtol=1e-5, atol=1e-6)
    assert np.abs(plain.numpy() - raw.numpy()).max() > 1e-3


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_dinovit_interpolated_pos_embed_matches_jax(dtype, tol):
    """A 3x5 patch grid against the trained 4x4 grid: the pos-embed goes
    through the antialiased bicubic resize."""
    kw = dict(img_size=56, patch_size=14, embed_dim=64, depth=1, num_heads=2)
    vit = DinoViT(ViTConfig(**kw), dtype=getattr(torch, dtype), attn_fn=tfa.attention)
    sd = perturbed_state_dict(vit, 7)
    sd["pos_embed"] = np.random.default_rng(8).standard_normal(
        sd["pos_embed"].shape).astype(np.float32)
    load_numpy(vit, sd)
    imgs = np.random.default_rng(9).standard_normal((2, 42, 70, 3)).astype(np.float32)
    jvit = JDinoViT(JViTConfig(**kw), dtype=getattr(jnp, dtype), attn_fn=jfa.attention)
    ref = jit(jvit.apply)(to_flax(sd), jnp.asarray(imgs).astype(getattr(jnp, dtype)))
    with torch.inference_mode():
        out = vit(torch.from_numpy(imgs).to(getattr(torch, dtype)))
    assert tuple(out.shape) == (2, 15, 64)
    assert rel_err(ref, out.float().numpy()) < tol


def test_bilinear_align_corners_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 5, 7, 3)).astype(np.float32)
    for hw in [(9, 12), (3, 4), (5, 7)]:
        out = tinterp.bilinear_resize_align_corners(torch.from_numpy(x), hw)
        ref = jinterp.bilinear_resize_align_corners(jnp.asarray(x), hw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_antialias_bicubic_matches_jax():
    """Down- and upscaling along either axis, as the pos-embed interpolation does."""
    x = np.random.default_rng(11).standard_normal((37, 37, 8)).astype(np.float32)
    for hw in [(24, 36), (37, 40), (3, 5)]:
        out = tinterp.resize_antialias_bicubic(torch.from_numpy(x), hw)
        ref = jinterp.resize_antialias_bicubic(jnp.asarray(x), hw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
