"""The port's fused LayerNorm (plain path, CPU) against the JAX package's
Pallas kernel in interpret mode, and the port's fused-LN forward against its
own baseline.

Tolerances, with their reasons:
- bf16 output: at most one bf16 ulp per element.  Both sides take fp32
  statistics with the two-pass variance and round once; only the order of
  the row sums differs, which can move a value across a rounding boundary.
- fp32 output: 1e-6 of max |ref| (the same, a few fp32 ulps).
- scaled IGGT with ``fused_ln=True`` against the port's baseline forward
  (fast-variance LayerNorm): 1e-5, as the JAX package holds its own fused
  path to its baseline (tests/test_heads.py::test_iggt_fused_ln_matches_baseline).
- scaled IGGT with ``fused_ln=True`` against JAX's ``IGGT.apply(...,
  fused_ln=True)``: fp32 heads 1e-3 relative (`test_torch_model.TOL`).  bf16
  decode heads: the median relative error (|a - b| / max(|a|, 1), the JAX
  package's own measure of this mode,
  tests/test_heads.py::test_iggt_bf16_head_fast_mode) under 3e-2 and the max
  error under 2e-1 of max |ref|: ten-odd bf16 layers round independently in
  the two packages (JAX's CPU attention also rounds its logits to bf16, the
  port's do not), and the errors seen, 4e-3 to 7e-3 median and 1.3e-2 to
  1.2e-1 max, are of the size of JAX's own bf16-vs-fp32 gap on the same
  weights (1.6e-2 to 8.5e-2 max).
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import bf16_ulps
from iggt_official_tpu.ops.fused_ln import fused_layernorm as jfused_layernorm
from iggt_official_tpu_torch.ops.fused_ln import fused_layernorm, fused_layernorm_plain

from .test_torch_helpers import rel_err, to_flax
from .test_torch_model import HW, OUTPUTS, TOL, _jax_forward, _port_model

BF16_HEADS_MEDIAN, BF16_HEADS_MAX = 3e-2, 2e-1


@functools.cache
def _dinov2_model(head):
    """The scaled DINOv2 IGGT (fp32 trunk) and its state dict, built once per
    head dtype in this process; the tests only run it in inference mode."""
    return _port_model("dinov2_vitl14_reg", "float32", head=head)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 1024])
def test_fused_layernorm_plain_matches_pallas(D, dtype, eps):
    """300 rows: the Pallas kernel's 256-row blocks leave a partial last one."""
    rng = np.random.default_rng(D)
    x = (2 * rng.standard_normal((300, D)) + rng.standard_normal((300, 1))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    launches = fused_layernorm.launches
    got = fused_layernorm(tx, torch.from_numpy(w), torch.from_numpy(b), eps)
    assert fused_layernorm.launches == launches  # CPU tensors never launch the kernel
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = np.asarray(jfused_layernorm(jnp.asarray(tx.float().numpy()).astype(dtype),
                                       jnp.asarray(w), jnp.asarray(b), eps=eps,
                                       interpret=True).astype(jnp.float32))
    got = got.float()
    if dtype == "bfloat16":
        assert bf16_ulps(got, torch.from_numpy(want)).max() <= 1.0
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_fused_layernorm_out_dtype_and_empty():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((5, 16)).astype(np.float32))
    w, b = torch.ones(16), torch.zeros(16)
    assert fused_layernorm(x, w, b, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    np.testing.assert_allclose(fused_layernorm_plain(x, w, b).numpy(),
                               torch.nn.functional.layer_norm(x, (16,), w, b, 1e-5).numpy(),
                               rtol=0, atol=1e-5)
    assert fused_layernorm(x[:0], w, b).shape == (0, 16)


def test_port_fused_ln_forward_matches_baseline():
    """The port's own fused path (every trunk pre-norm -- DINOv2, frame and
    global blocks -- through `fused_layernorm`, two-pass variance) against
    its baseline forward on the same weights: fp32 trunk, so the two differ
    by fp32 rounding only."""
    model, _ = _dinov2_model("float32")
    imgs = torch.from_numpy(
        np.random.default_rng(12).uniform(0, 1, (1, 2, *HW, 3)).astype(np.float32))
    with torch.inference_mode():
        base = model(imgs)
        fused = model(imgs, fused_ln=True)
    for k in ("depth", "pose_enc", "world_points", "part_feat"):
        np.testing.assert_allclose(base[k].numpy(), fused[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("head", ["float32", "bfloat16"])
def test_scaled_iggt_fused_ln_matches_jax(head):
    """forward(images, fused_ln=True) -- every trunk pre-norm (DINOv2, frame,
    global) through `fused_layernorm` -- against IGGT.apply(..., fused_ln=True)
    (the Pallas kernel in interpret mode), with fp32 and bf16 decode heads;
    fp32 trunk, so the LayerNorm path is held to fp32 rounding."""
    model, sd = _dinov2_model(head)
    imgs = np.random.default_rng(2).uniform(0, 1, (1, 2, *HW, 3)).astype(np.float32)
    ref = _jax_forward("dinov2_vitl14_reg", "float32", head, fused_ln=True)(
        to_flax(sd), jnp.asarray(imgs))
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs), fused_ln=True)
    for k in OUTPUTS:
        assert out[k].dtype == torch.float32, k
        a, b = np.asarray(ref[k]), out[k].numpy()
        if head == "float32":
            assert rel_err(a, b) < TOL["float32"], k
        else:
            assert np.median(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) < BF16_HEADS_MEDIAN, k
            assert rel_err(a, b) < BF16_HEADS_MAX, k
