"""Heads of the PyTorch port against the JAX package (fp32, as on the main path).

Same weights (made by the port, carried to JAX with its converter) and the
same numpy inputs through both.  Tolerance 1e-4 relative to the output's
magnitude: both compute in fp32 and differ only in summation order (errors
seen are ~1e-6).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from iggt_official_tpu.config import CameraHeadConfig as JCameraCfg
from iggt_official_tpu.config import DPTConfig as JDPTConfig
from iggt_official_tpu.config import PartHeadConfig as JPartCfg
from iggt_official_tpu.heads.adaptor import SamProjector as JSamProjector
from iggt_official_tpu.heads.camera_head import CameraHead as JCameraHead
from iggt_official_tpu.heads.dpt_head import DPTHead as JDPTHead
from iggt_official_tpu.heads.part_head import PartHead as JPartHead
from iggt_official_tpu.heads.window_attn import SwinCA as JSwinCA
from iggt_official_tpu.heads.window_attn import SwinSA as JSwinSA
from iggt_official_tpu_torch.config import CameraHeadConfig, DPTConfig, PartHeadConfig
from iggt_official_tpu_torch.heads.adaptor import SamProjector
from iggt_official_tpu_torch.heads.camera_head import CameraHead
from iggt_official_tpu_torch.heads.dpt_head import DPTHead
from iggt_official_tpu_torch.heads.part_head import PartHead
from iggt_official_tpu_torch.heads.window_attn import SwinCA, SwinSA

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

TOL = 1e-4
HW = (56, 70)          # a 4 x 5 patch grid
PSI = 5


def _tokens(seed, n_layers=4, B=1, S=2, C=128):
    rng = np.random.default_rng(seed)
    P = PSI + (HW[0] // 14) * (HW[1] // 14)
    return [rng.standard_normal((B, S, P, C)).astype(np.float32) for _ in range(n_layers)]


def _port(module, seed):
    sd = perturbed_state_dict(module, seed)
    load_numpy(module, sd)
    return module.eval(), to_flax(sd)


def _compare(ref, out):
    ref = jax.tree.leaves(ref)
    out = [o for o in jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel_err(a, b.detach().numpy()) < TOL


def test_camera_head_matches_jax():
    kw = dict(dim_in=128, num_heads=4, trunk_depth=2)
    head, params = _port(CameraHead(CameraHeadConfig(**kw)), 1)
    tok = _tokens(2, n_layers=1)[0]
    ref = jit(JCameraHead(JCameraCfg(**kw)).apply)(params, jnp.asarray(tok))
    with torch.inference_mode():
        out = head(torch.from_numpy(tok))
    assert len(out) == 4 and tuple(out[-1].shape) == (1, 2, 9)
    _compare(ref, out)


@pytest.mark.parametrize("use_point_feat", [False, True])
def test_dpt_head_matches_jax(use_point_feat):
    kw = dict(dim_in=128, out_channels=(16, 32, 64, 64), features=32,
              intermediate_layer_idx=(0, 1, 2, 3), use_point_feat=use_point_feat)
    head, params = _port(DPTHead(DPTConfig(**kw)), 3)
    toks = _tokens(4)
    ref = jit(lambda p, t: JDPTHead(JDPTConfig(**kw)).apply(p, t, HW, PSI))(
        params, [jnp.asarray(t) for t in toks])
    with torch.inference_mode():
        out = head([torch.from_numpy(t) for t in toks], HW, PSI)
    assert tuple(out[0].shape) == (1, 2, *HW, 3) and tuple(out[1].shape) == (1, 2, *HW)
    if use_point_feat:
        assert [tuple(t.shape) for t in out[2]] == [(2, 16, 20, 32), (2, 8, 10, 32),
                                                    (2, 4, 5, 32)]
    _compare(ref, out)


def test_sam_projector_matches_jax():
    kw = dict(dim_in=128, patch_size=14, intermediate_layer_idx=(0, 1, 2, 3),
              out_channels=(32, 32, 32, 32))
    proj, params = _port(SamProjector(**kw), 5)
    toks = _tokens(6)
    ref = jit(lambda p, t: JSamProjector(**kw).apply(p, t, HW, PSI))(
        params, [jnp.asarray(t) for t in toks])
    with torch.inference_mode():
        out = proj([torch.from_numpy(t) for t in toks], HW, PSI)
    assert [tuple(t.shape[1:3]) for t in out] == [(16, 20), (8, 10), (4, 5), (2, 3)]
    _compare(ref, out)


def test_swin_sa_matches_jax():
    """20 x 20 is not a multiple of the 8-pixel window: edge pad, then crop."""
    kw = dict(embed_dim=32, out_chans=32, num_heads=4, window_size=8)
    mod, params = _port(SwinSA(**kw), 7)
    x = np.random.default_rng(8).standard_normal((2, 20, 20, 32)).astype(np.float32)
    ref = jit(JSwinSA(**kw).apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        out = mod(torch.from_numpy(x))
    _compare(ref, out)


def test_swin_ca_reference_q_partition_matches_jax():
    kw = dict(embed_dim=32, out_chans=32, num_heads=4, window_size=8)
    mod, params = _port(SwinCA(**kw), 9)
    rng = np.random.default_rng(10)
    x, k, v = (rng.standard_normal((2, 20, 28, 32)).astype(np.float32) for _ in range(3))
    ref = jit(JSwinCA(**kw, q_window_mode="reference").apply)(
        params, *(jnp.asarray(a) for a in (x, k, v)))
    with torch.inference_mode():
        out = mod(*(torch.from_numpy(a) for a in (x, k, v)))
    _compare(ref, out)


def test_swin_ca_hat_q_partition_matches_jax():
    """q_window_mode="hat": row-major query windows, 20 x 28 edge-padded."""
    kw = dict(embed_dim=32, out_chans=32, num_heads=4, window_size=8)
    mod, params = _port(SwinCA(**kw, q_window_mode="hat"), 9)
    rng = np.random.default_rng(10)
    x, k, v = (rng.standard_normal((2, 20, 28, 32)).astype(np.float32) for _ in range(3))
    ref = jit(JSwinCA(**kw, q_window_mode="hat").apply)(
        params, *(jnp.asarray(a) for a in (x, k, v)))
    with torch.inference_mode():
        out = mod(*(torch.from_numpy(a) for a in (x, k, v)))
    _compare(ref, out)
    with pytest.raises(ValueError, match="q_window_mode"):
        SwinCA(**kw, q_window_mode="shifted")


def test_part_head_matches_jax():
    """Cross-attention at level 1x (head dim 32, the flash path), the window
    cross-attention at 4x, the window self-attention, the unused
    cross_attention_1 kept as parameters only."""
    kw = dict(dim_in=128, features=64, out_channels=(64, 64, 64, 64), ca_num_heads=2,
              intermediate_layer_idx=(0, 1, 2, 3))
    head, params = _port(PartHead(PartHeadConfig(**kw)), 11)
    assert "cross_attention_1.projq.weight" in head.state_dict()
    rng = np.random.default_rng(12)
    proj = [rng.standard_normal((2, h, w, 64)).astype(np.float32)
            for h, w in [(16, 20), (8, 10), (4, 5), (2, 3)]]
    pts = [rng.standard_normal((2, h, w, 64)).astype(np.float32)
           for h, w in [(16, 20), (8, 10), (4, 5)]]
    jhead = JPartHead(JPartCfg(**kw), images_hw=HW, batch_dims=(1, 2))
    ref = jit(jhead.apply)(params, [jnp.asarray(a) for a in proj],
                               [jnp.asarray(a) for a in pts])
    with torch.inference_mode():
        out = head([torch.from_numpy(a) for a in proj], [torch.from_numpy(a) for a in pts],
                   HW, (1, 2))
    assert tuple(out.shape) == (1, 2, *HW, 8)
    _compare(ref, out)


def test_part_head_hat_matches_jax():
    """The part head with `PartHeadConfig(q_window_mode="hat")` in both
    packages, at the same tolerance as the reference mode."""
    kw = dict(dim_in=128, features=64, out_channels=(64, 64, 64, 64), ca_num_heads=2,
              intermediate_layer_idx=(0, 1, 2, 3), q_window_mode="hat")
    head, params = _port(PartHead(PartHeadConfig(**kw)), 13)
    assert head.window_cross_attention.atten_block.q_window_mode == "hat"
    rng = np.random.default_rng(14)
    proj = [rng.standard_normal((2, h, w, 64)).astype(np.float32)
            for h, w in [(16, 20), (8, 10), (4, 5), (2, 3)]]
    pts = [rng.standard_normal((2, h, w, 64)).astype(np.float32)
           for h, w in [(16, 20), (8, 10), (4, 5)]]
    jhead = JPartHead(JPartCfg(**kw), images_hw=HW, batch_dims=(1, 2))
    ref = jit(jhead.apply)(params, [jnp.asarray(a) for a in proj],
                           [jnp.asarray(a) for a in pts])
    with torch.inference_mode():
        out = head([torch.from_numpy(a) for a in proj], [torch.from_numpy(a) for a in pts],
                   HW, (1, 2))
    _compare(ref, out)
