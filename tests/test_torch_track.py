"""The port's track head (`heads/track/`), `VGGT` and the merged, tracked
IGGT forward against the JAX package, on the CPU.

Inputs come from numpy seeds; weights from the port's seeded init, perturbed
(`test_torch_helpers.perturbed_state_dict`) and carried to JAX with its own
converter.  Tolerances:

- sampling, embeddings, pyramid and correlation: 1e-6 abs (fp32, the same
  gathers and weights in the same order; the pyramid's sums and the
  correlation matmul may round in another order);
- the update former: 1e-5 relative (fp32 matmuls in another summation
  order);
- the predictor and the track head, two refinement iterations: 1e-4
  relative.  With random weights each iteration multiplies a difference in
  its input by 10 to 50 (the correlation of random feature maps changes
  from pixel to pixel, and the coordinates move by pixels), so fp32
  rounding (~1e-7) is held to 1e-4 after two iterations;
- the whole slice (a scaled IGGT with global_merge_r > 0, enable_track=True
  and query points) at `tests/test_torch_model.py`'s limits, 1e-3 relative
  with an fp32 trunk and 3e-2 with a bf16 trunk, for every output, track
  coordinates included.  The fp32 trunk runs two refinement iterations.
  The bf16 trunk runs one: its tokens differ by bf16 rounding (~1e-2
  relative) before the track head, and the factor above takes that past
  3e-2 at the second iteration, while the two-iteration path is held in
  fp32.  The merge plan is computed
  from the trunk's input tokens on each side; it compares where those
  tokens decide it (the gaps at the r-th place are asserted, as in
  `test_torch_token_merge.py`).  View 0's track equals the query points
  exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggt_official_tpu.config import ModelConfig as JModelConfig
from iggt_official_tpu.config import TrackHeadConfig as JTrackHeadConfig
from iggt_official_tpu.heads.track import corr as jcorr
from iggt_official_tpu.heads.track import sampling as jsampling
from iggt_official_tpu.heads.track.modules import EfficientUpdateFormer as JUpdateFormer
from iggt_official_tpu.heads.track.predictor import BaseTrackerPredictor as JPredictor
from iggt_official_tpu.heads.track.track_head import TrackHead as JTrackHead
from iggt_official_tpu.models.vggt import IGGT as JIGGT
from iggt_official_tpu.models.vggt import VGGT as JVGGT
from iggt_official_tpu.ops.flash_attention import attention as jattention
from iggt_official_tpu_torch.config import ModelConfig, TrackHeadConfig
from iggt_official_tpu_torch.heads.track import corr, sampling
from iggt_official_tpu_torch.heads.track.modules import EfficientUpdateFormer
from iggt_official_tpu_torch.heads.track.predictor import BaseTrackerPredictor
from iggt_official_tpu_torch.heads.track.track_head import TrackHead
from iggt_official_tpu_torch.models import aggregator as agg_module
from iggt_official_tpu_torch.models.vggt import build_model
from iggt_official_tpu_torch.utils.convert import jax_params_to_torch_state_dict
from iggt_official_tpu_torch.utils.init import init_params

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax
from .test_torch_token_merge import GAP, _decision_gaps, _recording_plans

TOL = {"float32": 1e-3, "bfloat16": 3e-2}
TRACKER_TOL = 1e-4
SCALED = dict(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56, patch_embed="conv")
SMALL_TRACK = dict(features=32, hidden_size=64)
ITERS = {"float32": 2, "bfloat16": 1}


def _rng(seed):
    return np.random.default_rng(seed)


def _ported(module, seed):
    init_params(module, torch.Generator().manual_seed(seed))
    sd = perturbed_state_dict(module, seed + 100)
    return load_numpy(module, sd).eval(), to_flax(sd)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bilinear_sample_matches_jax(padding):
    """A ragged (2, 7, 9, 5) map at 40 points per batch, a third of them
    outside the map (up to 3 pixels past each edge) and some on its edges."""
    rng = _rng(0)
    fmap = rng.standard_normal((2, 7, 9, 5)).astype(np.float32)
    pts = np.stack([rng.uniform(-3, 11, (2, 4, 10)), rng.uniform(-3, 9, (2, 4, 10))],
                   -1).astype(np.float32)
    pts[:, 0, :3] = [[0, 0], [8, 6], [8, 0]]
    assert ((pts[..., 0] < 0) | (pts[..., 0] > 8) | (pts[..., 1] < 0)
            | (pts[..., 1] > 6)).mean() > 0.3
    ref = jsampling.bilinear_sample_nhwc(jnp.asarray(fmap), jnp.asarray(pts), padding)
    out = sampling.bilinear_sample_nhwc(torch.from_numpy(fmap), torch.from_numpy(pts), padding)
    assert out.shape == (2, 4, 10, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_embeddings_match_jax():
    xy = _rng(1).uniform(-60, 60, (2, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sampling.get_2d_embedding(torch.from_numpy(xy), 16).numpy(),
        np.asarray(jsampling.get_2d_embedding(jnp.asarray(xy), 16)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        sampling.get_2d_sincos_pos_embed(40, (5, 7)).numpy(),
        np.asarray(jsampling.get_2d_sincos_pos_embed(40, (5, 7))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(20, 26), (5, 6)])
def test_pyramid_and_correlation_match_jax(hw):
    """7 levels on a (1, 2, h, w, 8) map; at 5x6 the map is exhausted after
    two poolings, so the coarsest level repeats at its real scale."""
    rng = _rng(2)
    fmaps = rng.standard_normal((1, 2, *hw, 8)).astype(np.float32)
    targets = rng.standard_normal((1, 2, 6, 8)).astype(np.float32)
    coords = np.stack([rng.uniform(-2, hw[1] + 1, (1, 2, 6)),
                       rng.uniform(-2, hw[0] + 1, (1, 2, 6))], -1).astype(np.float32)
    jlevels, jscales = jcorr.build_pyramid(jnp.asarray(fmaps), 7)
    levels, scales = corr.build_pyramid(torch.from_numpy(fmaps), 7)
    assert scales == jscales
    if hw == (5, 6):
        assert scales == [1.0, 2.0, 4.0, 4.0, 4.0, 4.0, 4.0]
    for a, b in zip(jlevels, levels):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    ref = jcorr.corr_sample(jlevels, jscales, jnp.asarray(targets), jnp.asarray(coords), 2)
    out = corr.corr_sample(levels, scales, torch.from_numpy(targets),
                           torch.from_numpy(coords), 2)
    assert out.shape == (1, 2, 6, 7 * 25)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_update_former_matches_jax():
    """2 time + 2 space blocks, hidden 32 (4 heads of 8), 4 virtual tracks."""
    kw = dict(space_depth=2, time_depth=2, hidden_size=32, num_heads=4, output_dim=10,
              num_virtual_tracks=4)
    model, params = _ported(EfficientUpdateFormer(input_dim=20, **kw), 3)
    x = _rng(4).standard_normal((2, 5, 3, 20)).astype(np.float32)
    ref = jit(lambda p, t: JUpdateFormer(**kw).apply(p, t))(params, jnp.asarray(x))
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert rel_err(ref, out.numpy()) < 1e-5


def test_tracker_predictor_matches_jax():
    """Features 16, hidden 32, depth 2, 2 iterations over (1, 3, 12, 14, 16)
    feature maps and 5 queries: every iteration's coordinates, visibility
    and confidence."""
    cfg = TrackHeadConfig(features=16, hidden_size=32, iters=2, corr_levels=4, corr_radius=2)
    model, params = _ported(BaseTrackerPredictor(cfg, depth=2), 5)
    rng = _rng(6)
    fmaps = rng.standard_normal((1, 3, 12, 14, 16)).astype(np.float32)
    queries = np.stack([rng.uniform(0, 26, (1, 5)), rng.uniform(0, 22, (1, 5))],
                       -1).astype(np.float32)
    jmodel = JPredictor(JTrackHeadConfig(**dataclasses.asdict(cfg)), depth=2)
    ref = jit(lambda p, q, f: jmodel.apply(p, q, f))(params, jnp.asarray(queries),
                                                    jnp.asarray(fmaps))
    with torch.inference_mode():
        out = model(torch.from_numpy(queries), torch.from_numpy(fmaps))
    assert len(out[0]) == 2
    for a, b in zip(ref[0], out[0]):
        assert rel_err(a, b.numpy()) < TRACKER_TOL
        np.testing.assert_array_equal(b[:, 0].numpy(), queries)
    assert rel_err(ref[1], out[1].numpy()) < TRACKER_TOL
    assert rel_err(ref[2], out[2].numpy()) < TRACKER_TOL


def test_track_head_matches_jax():
    """The DPT feature extractor (half resolution, features 32) and the
    predictor over 4 random token maps of 2 views at 42x56 px."""
    cfg = TrackHeadConfig(dim_in=64, features=32, hidden_size=64, iters=2,
                          intermediate_layer_idx=(0, 1, 2, 3))
    model, params = _ported(TrackHead(cfg), 7)
    rng = _rng(8)
    H, W, psi = 42, 56, 5
    toks = [rng.standard_normal((1, 2, psi + 12, 64)).astype(np.float32) for _ in range(4)]
    queries = np.stack([rng.uniform(0, W - 1, (1, 6)), rng.uniform(0, H - 1, (1, 6))],
                       -1).astype(np.float32)
    jmodel = JTrackHead(JTrackHeadConfig(**dataclasses.asdict(cfg)))
    ref = jit(lambda p, t, q: jmodel.apply(p, t, (H, W), psi, q))(
        params, [jnp.asarray(t) for t in toks], jnp.asarray(queries))
    with torch.inference_mode():
        fmaps = model.feature_extractor([torch.from_numpy(t) for t in toks], (H, W), psi)
        out = model([torch.from_numpy(t) for t in toks], (H, W), psi,
                    torch.from_numpy(queries))
    assert fmaps.shape == (1, 2, H // 2, W // 2, 32) and fmaps.dtype == torch.float32
    for a, b in zip(ref[0], out[0]):
        assert rel_err(a, b.numpy()) < TRACKER_TOL
    assert rel_err(ref[1], out[1].numpy()) < TRACKER_TOL
    assert rel_err(ref[2], out[2].numpy()) < TRACKER_TOL


def _slice_configs(trunk, name="iggt", enable_track=True):
    out = []
    for base in (ModelConfig(), JModelConfig()):
        cfg = base.scaled(**SCALED)
        out.append(dataclasses.replace(
            cfg, name=name, trunk_dtype=trunk, enable_track=enable_track,
            track=dataclasses.replace(cfg.track, iters=ITERS[trunk], **SMALL_TRACK)))
    return out


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
def test_merged_tracked_iggt_matches_jax(trunk, monkeypatch):
    """A scaled IGGT, 3 views at 56x70 px (20 merge candidates), merged at
    r = 12, with the track head (ITERS refinement iterations) and 8 query
    points in view 0: every output against JAX's
    IGGT.apply(..., global_merge_r=12) on the same weights."""
    cfg, jcfg = _slice_configs(trunk)
    model = build_model(cfg, device="cpu", seed=0)
    sd = perturbed_state_dict(model, 21)
    load_numpy(model, sd)
    rng = _rng(9)
    imgs = rng.uniform(0, 1, (1, 3, 56, 70, 3)).astype(np.float32)
    queries = np.stack([rng.uniform(0, 69, (1, 8)), rng.uniform(0, 55, (1, 8))],
                       -1).astype(np.float32)
    jmodel = JIGGT(jcfg)
    ref = jit(lambda p, x, q: jmodel.apply(p, x, query_points=q, attn_fn=jattention,
                                           global_merge_r=12))(
        to_flax(sd), jnp.asarray(imgs), jnp.asarray(queries))
    plans = _recording_plans(monkeypatch, agg_module)
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs), query_points=torch.from_numpy(queries),
                    global_merge_r=12)
    (x, r, protect), = plans
    assert r == 12 and min(_decision_gaps(x, protect, r)) > GAP
    keys = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf",
            "part_feat", "track", "vis", "conf")
    assert set(keys) <= set(ref) and set(keys) <= set(out)
    for k in keys:
        assert tuple(out[k].shape) == tuple(ref[k].shape), k
        assert rel_err(ref[k], out[k].numpy()) < TOL[trunk], k
    assert out["track"].shape == (1, 3, 8, 2)
    np.testing.assert_array_equal(out["track"][:, 0].numpy(), queries)


def test_track_head_weights_carry_both_ways():
    """A scaled IGGT with the track head: port state dict -> JAX params (the
    JAX package's converter) -> port state dict (`utils/convert.py`) gives
    the same names and tensors, the tracker's Sequential heads
    (``ffeat_updater.0``, ``vis_predictor.0``, ``conf_predictor.0``) and its
    blocks included, and loads strictly."""
    cfg, _ = _slice_configs("float32")
    model = build_model(cfg, device="cpu", seed=2)
    sd = perturbed_state_dict(model, 41)
    carried = jax_params_to_torch_state_dict(to_flax(sd))
    assert set(carried) == set(sd)
    assert {"track_head.tracker.ffeat_updater.0.weight", "track_head.tracker.vis_predictor.0.bias",
            "track_head.tracker.conf_predictor.0.weight",
            "track_head.tracker.updateformer.space_virtual2point_blocks.5.cross_attn."
            "in_proj_weight"} <= set(carried)
    for name, value in carried.items():
        np.testing.assert_array_equal(value.numpy(), sd[name], err_msg=name)
    model.load_state_dict(carried, strict=True)


def test_vggt_and_feat_only_match_jax():
    """VGGT (fp32 trunk, no part head, a point head without the fusion
    pyramid) on its own weights: the forward and the feat_only pass."""
    cfg, jcfg = _slice_configs("float32", name="vggt", enable_track=False)
    model = build_model(cfg, device="cpu", seed=1)
    assert type(model).__name__ == "VGGT"
    assert not any(k.startswith(("part_", "track_")) for k in model.state_dict())
    sd = perturbed_state_dict(model, 31)
    load_numpy(model, sd)
    imgs = _rng(10).uniform(0, 1, (1, 2, 56, 70, 3)).astype(np.float32)
    jmodel = JVGGT(jcfg)
    ref, ref_feat = jit(lambda p, x: (jmodel.apply(p, x, attn_fn=jattention),
                                      jmodel.apply(p, x, attn_fn=jattention,
                                                   feat_only=True)))(
        to_flax(sd), jnp.asarray(imgs))
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs))
        feat = model(torch.from_numpy(imgs), feat_only=True)
    assert set(out) == set(ref)
    for k in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        assert rel_err(ref[k], out[k].numpy()) < TOL["float32"], k
    assert set(feat) == set(ref_feat) == {"cam_token", "depth", "point", "images"}
    assert rel_err(ref_feat["cam_token"], feat["cam_token"].numpy()) < TOL["float32"]
    for k in ("depth", "point"):
        for a, b in zip(ref_feat[k], feat[k]):
            assert rel_err(a, b.numpy()) < TOL["float32"], k
    np.testing.assert_array_equal(feat["images"].numpy(), imgs)


def test_track_visuals_match_jax(tmp_path):
    """The numpy-only track drawing against the JAX package's (matplotlib's
    hsv): 5 frames, 30 tracks, some off the image, some invisible; equal
    frames and equal PNG bytes."""
    from iggt_official_tpu.utils.visual_track import visualize_tracks_on_images as jvisualize
    from iggt_official_tpu_torch.utils.visual_track import visualize_tracks_on_images

    rng = _rng(11)
    imgs = rng.uniform(0, 1, (1, 5, 40, 50, 3)).astype(np.float32)
    tracks = np.stack([rng.uniform(-5, 55, (1, 5, 30)), rng.uniform(-5, 45, (1, 5, 30))],
                      -1).astype(np.float32)
    vis = rng.uniform(0, 1, (1, 5, 30)) > 0.3
    ref = jvisualize(imgs, tracks, vis, out_dir=str(tmp_path / "jax"), frames_per_row=2)
    out = visualize_tracks_on_images(imgs, tracks, vis, out_dir=str(tmp_path / "port"),
                                     frames_per_row=2)
    np.testing.assert_array_equal(out, ref)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
