"""The port's SAM2 image path (`iggt_official_tpu_torch/sam2/`) against the JAX
package's, on the CPU.

Weights: the JAX package's seeded init of `SAM2Base.init_all` (jitted),
carried into the port by `utils/convert.py::jax_sam2_params_to_torch_state_dict`
and loaded strictly, so every entry of the converter is exercised.  Inputs
come from numpy seeds.  `SAM2Config().scaled()` has head dim 16 at every
stage; the image encoder also runs at `scaled(embed_dim=72)`, head dim 72,
the card's shape.  Tolerances: fp32 outputs within 1e-5 of max|ref| (the two
frameworks sum in other orders); binary masks equal except at pixels whose
logit lies within 1e-4 of the threshold; connected-component labels,
manifest names and loader reports exactly.
"""

import json
import os.path as op

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from iggt_official_tpu.ops import connected_components as jax_cc
from iggt_official_tpu.ops.flash_attention import attention as jax_attention
from iggt_official_tpu.sam2.amg import SAM2AutomaticMaskGenerator as JaxAMG
from iggt_official_tpu.sam2.base import SAM2Base as JaxSAM2
from iggt_official_tpu.sam2.common import PositionEmbeddingSine as JaxSine
from iggt_official_tpu.sam2.hiera import ImageEncoder as JaxImageEncoder
from iggt_official_tpu.sam2.image_predictor import SAM2ImagePredictor as JaxPredictor
from iggt_official_tpu.sam2.transforms import ResizeLongestSide as JaxResizeLongestSide
from iggt_official_tpu.sam2.transforms import SAM2Transforms as JaxSAM2Transforms
from iggt_official_tpu_torch.ops import connected_components as cc
from iggt_official_tpu_torch.ops.flash_attention import attention
from iggt_official_tpu_torch.sam2.amg import SAM2AutomaticMaskGenerator, rle_to_mask
from iggt_official_tpu_torch.sam2.base import SAM2Base
from iggt_official_tpu_torch.sam2.build import build_sam2
from iggt_official_tpu_torch.sam2.common import PositionEmbeddingSine
from iggt_official_tpu_torch.sam2.config import SAM2Config, sam2_hiera_l
from iggt_official_tpu_torch.sam2.hiera import ImageEncoder
from iggt_official_tpu_torch.sam2.image_predictor import SAM2ImagePredictor
from iggt_official_tpu_torch.sam2.transforms import ResizeLongestSide, SAM2Transforms
from iggt_official_tpu_torch.utils import checkpoint as ckpt
from iggt_official_tpu_torch.utils.convert import jax_sam2_params_to_torch_state_dict

from .test_torch_helpers import jit, rel_err

REPO = op.dirname(op.dirname(op.abspath(__file__)))
MANIFEST = op.join(REPO, "tests", "data", "sam2_l_state_dict_manifest.json")
FP32 = 1e-5
MASK_MARGIN = 1e-4


@pytest.fixture(scope="module")
def sam():
    """(cfg, JAX module, JAX params, port model) for `SAM2Config().scaled()`."""
    cfg = SAM2Config().scaled()
    jm = JaxSAM2(cfg)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = jit(lambda: jm.init(jax.random.PRNGKey(3), img, method=JaxSAM2.init_all))()
    model = SAM2Base(cfg).eval().requires_grad_(False)
    model.load_state_dict(jax_sam2_params_to_torch_state_dict(params), strict=True)
    return cfg, jm, params, model


def _images(seed, n=1, hw=(64, 64)):
    return np.random.default_rng(seed).standard_normal((n,) + hw + (3,)).astype(np.float32)


def _assert_fp32(ref, out):
    assert np.asarray(ref).shape == tuple(out.shape)
    assert out.numel() == 0 or rel_err(ref, out.detach().numpy()) <= FP32


def _assert_masks(ref_logits, ref_masks, out_masks, threshold=0.0):
    """Binary masks equal except where the reference logit is within
    MASK_MARGIN of the threshold."""
    ref_logits, ref_masks = np.asarray(ref_logits), np.asarray(ref_masks)
    differ = ref_masks != np.asarray(out_masks)
    assert not (differ & (np.abs(ref_logits - threshold) > MASK_MARGIN)).any()


# ---------------------------------------------------------------------------
# 1. image encoder

@pytest.mark.parametrize("embed_dim", [16, 72])
def test_image_encoder_matches_jax(embed_dim):
    """backbone_fpn and vision_pos_enc at head dim 16 (`scaled()`) and 72
    (`scaled(embed_dim=72)`, every stage's head dim the card's 72)."""
    cfg = SAM2Config().scaled(embed_dim=embed_dim)
    jm = JaxImageEncoder(cfg)
    x = _images(embed_dim, n=2)
    params = jit(lambda: jm.init(jax.random.PRNGKey(embed_dim), jnp.asarray(x)))()
    sd = jax_sam2_params_to_torch_state_dict({"image_encoder": params["params"]})
    model = ImageEncoder(cfg).eval()
    model.load_state_dict({k[len("image_encoder."):]: v for k, v in sd.items()}, strict=True)
    ref = jit(lambda p, x: jm.apply(p, x))(params, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key in ("backbone_fpn", "vision_pos_enc"):
        assert len(ref[key]) == len(out[key]) == 3
        for a, b in zip(ref[key], out[key]):
            _assert_fp32(a, b)


def test_sine_encodings_and_resize_longest_side_match_jax():
    """`PositionEmbeddingSine`'s grid, point and box encodings, and
    `ResizeLongestSide` (image, coordinates, boxes)."""
    rng = np.random.default_rng(4)
    x, y, w, h = rng.uniform(0, 1, (4, 2, 5)).astype(np.float32)
    labels = rng.integers(-1, 4, (2, 5)).astype(np.float32)
    ours, ref = PositionEmbeddingSine(32), JaxSine(32)
    _assert_fp32(ref(6, 9), ours(6, 9))
    t = [torch.from_numpy(a) for a in (x, y, w, h, labels)]
    _assert_fp32(ref.encode_boxes(x, y, w, h), ours.encode_boxes(*t[:4]))
    _assert_fp32(ref.encode_points(x, y, labels), ours.encode_points(t[0], t[1], t[4]))
    image = rng.integers(0, 255, (30, 47, 3), dtype=np.uint8)
    coords = rng.uniform(0, 47, (3, 2))
    boxes = rng.uniform(0, 30, (2, 4))
    ours, ref = ResizeLongestSide(64), JaxResizeLongestSide(64)
    np.testing.assert_array_equal(ours.apply_image(image), ref.apply_image(image))
    np.testing.assert_array_equal(ours.apply_coords(coords, (30, 47)),
                                  ref.apply_coords(coords, (30, 47)))
    np.testing.assert_array_equal(ours.apply_boxes(boxes, (30, 47)),
                                  ref.apply_boxes(boxes, (30, 47)))


# ---------------------------------------------------------------------------
# 2-3. prompt encoder, mask decoder

def test_prompt_encoder_matches_jax(sam):
    """Sparse and dense embeddings of points (padded), points with a box, and
    a mask prompt."""
    cfg, jm, params, model = sam
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 64, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [2, 3, 1]], np.int32)
    boxes = rng.uniform(0, 64, (2, 4)).astype(np.float32)
    masks = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    cases = [dict(points=(coords, labels)), dict(points=(coords, labels), boxes=boxes),
             dict(boxes=boxes, masks=masks)]

    def jax_fn(p, cases):
        return ([jm.apply(p, method=lambda m, kw=kw: m.sam_prompt_encoder(**kw)) for kw in cases],
                jm.apply(p, method=lambda m: m.sam_prompt_encoder.get_dense_pe()))

    refs, ref_pe = jit(jax_fn)(params, jax.tree_util.tree_map(jnp.asarray, cases))
    with torch.no_grad():
        for kw, ref in zip(cases, refs):
            out = model.sam_prompt_encoder(**jax.tree_util.tree_map(torch.from_numpy, kw))
            for a, b in zip(ref, out):
                _assert_fp32(a, b)
        _assert_fp32(ref_pe, model.sam_prompt_encoder.get_dense_pe())


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(sam, multimask):
    """`forward_sam_heads` on the image features: low- and high-res logits,
    IoUs, object pointer and object score for two point prompts and a mask
    prompt; single-mask output takes the stability-based choice."""
    cfg, jm, params, model = sam
    x = _images(7)
    rng = np.random.default_rng(8)
    pts = {"point_coords": rng.uniform(0, 64, (2, 2, 2)).astype(np.float32),
           "point_labels": np.array([[1, 0], [1, 1]], np.int32)}
    mask_in = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)

    def jax_fn(p, x, pts, mask_in):
        out = jm.apply(p, x, method=JaxSAM2.forward_image)
        feats = jnp.broadcast_to(out["backbone_fpn"][-1], (2,) + out["backbone_fpn"][-1].shape[1:])
        hi = [jnp.broadcast_to(f, (2,) + f.shape[1:]) for f in out["backbone_fpn"][:2]]
        return jm.apply(p, feats, pts, mask_in, hi, multimask,
                        method=JaxSAM2.forward_sam_heads)

    ref = jit(jax_fn)(params, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, pts),
                      jnp.asarray(mask_in))
    with torch.no_grad():
        out = model.forward_image(torch.from_numpy(x))
        feats = out["backbone_fpn"][-1].expand(2, -1, -1, -1)
        hi = [f.expand(2, -1, -1, -1) for f in out["backbone_fpn"][:2]]
        got = model.forward_sam_heads(feats, {k: torch.from_numpy(v) for k, v in pts.items()},
                                      torch.from_numpy(mask_in), hi, multimask)
    for a, b in zip(ref, got):
        _assert_fp32(a, b)


# ---------------------------------------------------------------------------
# 4-5. image predictor, automatic mask generator

def test_image_predictor_matches_jax(sam):
    """`predict` with points, a box, a box with points and a mask input, and
    `predict_point_batch`, on a non-square uint8 image."""
    cfg, jm, params, model = sam
    image = np.random.default_rng(9).integers(0, 255, (48, 80, 3), dtype=np.uint8)
    jp, tp = JaxPredictor(jm, params), SAM2ImagePredictor(model)
    jp.set_image(image)
    tp.set_image(image)
    for a, b in zip(jp._features["backbone_fpn"], tp._features["backbone_fpn"]):
        _assert_fp32(a, b)
    low_in = np.random.default_rng(10).standard_normal((1, 16, 16)).astype(np.float32)
    prompts = [dict(point_coords=np.array([[40.0, 20.0], [10.0, 30.0]]),
                    point_labels=np.array([1, 0])),
               dict(box=np.array([8, 6, 60, 40])),
               dict(box=np.array([8, 6, 60, 40]), point_coords=np.array([[30.0, 20.0]]),
                    point_labels=np.array([1]), multimask_output=False),
               dict(point_coords=np.array([[40.0, 20.0]]), point_labels=np.array([1]),
                    mask_input=low_in)]
    for kw in prompts:
        ref_logits, ref_iou, ref_low = jp.predict(**kw, return_logits=True)
        ref_masks, _, _ = jp.predict(**kw)
        masks, iou, low = tp.predict(**kw)
        logits, _, _ = tp.predict(**kw, return_logits=True)
        assert rel_err(ref_logits, logits) <= FP32
        assert rel_err(ref_iou, iou) <= FP32 and rel_err(ref_low, low) <= FP32
        _assert_masks(ref_logits, ref_masks, masks)
    grid = np.random.default_rng(11).uniform(0, 48, (5, 2))
    ref_low, ref_iou = jp.predict_point_batch(grid)
    low, iou = tp.predict_point_batch(grid)
    _assert_fp32(ref_low, low)
    _assert_fp32(ref_iou, iou)


@pytest.mark.parametrize("thresholds", [(0.0, 0.0), (0.33, 0.1)])
def test_automatic_mask_generator_matches_jax(sam, thresholds):
    """`generate` on a seeded image with flat regions: the same number of
    masks; each port mask matched to the JAX mask of its box (NMS leaves one
    mask per box), with equal RLE, area, point, IoU and stability score.
    The object-score head's output bias is raised by 8 in both packages, so
    that random weights predict objects and the masks are not all empty."""
    cfg, jm, params, _ = sam
    head = params["params"]["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]
    params = jax.tree_util.tree_map(lambda a: a, params)
    params["params"]["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"] = dict(
        head, bias=head["bias"] + 8.0)
    model = SAM2Base(cfg).eval().requires_grad_(False)
    model.load_state_dict(jax_sam2_params_to_torch_state_dict(params), strict=True)
    rng = np.random.default_rng(12)
    image = np.zeros((40, 56, 3), np.uint8)
    image[:, :28] = (200, 40, 40)
    image[20:, 28:] = (30, 160, 60)
    image = (image + rng.integers(0, 20, image.shape)).astype(np.uint8)
    iou_t, stab_t = thresholds
    kw = dict(points_per_side=4, points_per_batch=6, pred_iou_thresh=iou_t,
              stability_score_thresh=stab_t, output_mode="uncompressed_rle")
    ref = JaxAMG(JaxPredictor(jm, params), **kw).generate(image)
    out = SAM2AutomaticMaskGenerator(SAM2ImagePredictor(model), **kw).generate(image)
    assert len(out) == len(ref) and any(r["area"] > 0 for r in ref)
    by_box = {tuple(r["bbox"]): r for r in ref}
    assert len(by_box) == len(ref)
    for r in out:
        want = by_box[tuple(r["bbox"])]
        assert r["segmentation"] == want["segmentation"]
        assert r["area"] == want["area"] and r["point_coords"] == want["point_coords"]
        assert abs(r["predicted_iou"] - want["predicted_iou"]) <= FP32
        assert r["stability_score"] == pytest.approx(want["stability_score"], abs=1e-3)
        assert rle_to_mask(r["segmentation"]).sum() == r["area"]


# ---------------------------------------------------------------------------
# 6. memory path, one step

def test_memory_step_matches_jax(sam):
    """`encode_new_memory`, `condition_on_memory` (MemoryAttention with a
    padded bank and pointer tokens) and one `propagate_step`."""
    cfg, jm, params, model = sam
    rng = np.random.default_rng(13)
    h = cfg.image_size // 16
    md, C = cfg.mem_dim, cfg.d_model
    x = _images(14)
    feats = rng.standard_normal((1, h, h, C)).astype(np.float32)
    curr_pos = rng.standard_normal((1, h * h, C)).astype(np.float32)
    masks_hr = rng.standard_normal((1, 16 * h, 16 * h, 1)).astype(np.float32) * 4
    obj = np.array([[0.7]], np.float32)
    mem = tuple(rng.standard_normal((1, h * h, md)).astype(np.float32) for _ in range(2))
    mpos = tuple(rng.standard_normal((1, h * h, md)).astype(np.float32) for _ in range(2))
    tpos = np.array([1, 4], np.int32)
    valid = np.array([True, False])
    ptrs = tuple(rng.standard_normal((C,)).astype(np.float32) for _ in range(3))
    ptr_norm = np.array([0.0, 0.25, 0.5], np.float32)
    keys = np.repeat(valid, h * h)[None]
    n_valid = np.int32(2)

    def jax_fn(p, x, feats, curr_pos, masks_hr, obj, mem, mpos, tpos, valid, ptrs, ptr_norm,
               keys, n_valid):
        enc = jm.apply(p, feats, masks_hr, obj, method=JaxSAM2.encode_new_memory)
        cond = jm.apply(p, feats.reshape(1, -1, C), curr_pos, jnp.concatenate(mem, 1),
                        jnp.concatenate(mpos, 1), 0, keys, method=JaxSAM2.condition_on_memory)
        hi = list(jm.apply(p, x, method=JaxSAM2.forward_image)["backbone_fpn"][:2])
        step = jm.apply(p, feats, curr_pos, hi, mem, mpos, tpos, valid, ptrs, ptr_norm, n_valid,
                        True, method=JaxSAM2.propagate_step)
        return enc, cond, step

    args = (x, feats, curr_pos, masks_hr, obj, mem, mpos, tpos, valid, ptrs, ptr_norm, keys,
            n_valid)
    ref = jit(jax_fn)(params, *jax.tree_util.tree_map(jnp.asarray, args))
    t = jax.tree_util.tree_map(torch.from_numpy, args[:-1]) + (torch.tensor(2),)
    (x_t, feats_t, cpos_t, masks_t, obj_t, mem_t, mpos_t, tpos_t, valid_t, ptrs_t, norm_t,
     keys_t, nvalid_t) = t
    with torch.no_grad():
        enc = model.encode_new_memory(feats_t, masks_t, obj_t)
        cond = model.condition_on_memory(feats_t.reshape(1, -1, C), cpos_t, torch.cat(mem_t, 1),
                                         torch.cat(mpos_t, 1), 0, keys_t)
        hi = model.forward_image(x_t)["backbone_fpn"][:2]
        step = model.propagate_step(feats_t, cpos_t, hi, mem_t, mpos_t, tpos_t.long(), valid_t,
                                    ptrs_t, norm_t, nvalid_t, True)
    for a, b in zip(jax.tree_util.tree_leaves((ref[0], ref[1], ref[2])),
                    [*enc, cond, *step]):
        _assert_fp32(a, b)


# ---------------------------------------------------------------------------
# 7. Hiera-shaped attention at head dim 72

@pytest.mark.parametrize("nq,nk", [(4, 16), (16, 64), (64, 64)])
def test_hiera_attention_head_dim_72(nq, nk):
    """The port's `attention` (the kernel's plain version on the CPU) against
    the JAX package's at Hiera's window shapes, pooled queries included."""
    rng = np.random.default_rng(nq + nk)
    q = rng.standard_normal((32, nq, 4, 72)).astype(np.float32)
    k, v = (rng.standard_normal((32, nk, 4, 72)).astype(np.float32) for _ in range(2))
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _assert_fp32(ref, attention(*map(torch.from_numpy, (q, k, v))))


# ---------------------------------------------------------------------------
# 8. connected components

def test_connected_components_matches_jax_and_scipy():
    """Labels (smallest linear index + 1) and areas: the torch version, the
    native host version, the JAX package's and scipy's 8-connected labels."""
    rng = np.random.default_rng(15)
    masks = np.concatenate([rng.random((3, 37, 53)) > 0.55,
                            np.zeros((1, 37, 53), bool), np.ones((1, 37, 53), bool)])
    labels, areas = (t.numpy() for t in cc.connected_components(torch.from_numpy(masks)))
    host_labels, host_areas = cc.connected_components_host(masks)
    jl, ja = (np.asarray(a) for a in jax_cc.connected_components(jnp.asarray(masks)))
    for got in (host_labels, jl):
        np.testing.assert_array_equal(labels, got)
    for got in (host_areas, ja):
        np.testing.assert_array_equal(areas, got)
    for m, lab, area in zip(masks, labels, areas):
        sl, n = ndimage.label(m, structure=np.ones((3, 3)))
        want = np.zeros_like(lab)
        want_area = np.zeros_like(area)
        for i in range(1, n + 1):
            idx = np.flatnonzero(sl.ravel() == i)
            want.ravel()[idx] = idx.min() + 1
            want_area.ravel()[idx] = len(idx)
        np.testing.assert_array_equal(lab, want)
        np.testing.assert_array_equal(area, want_area)
    scores = torch.from_numpy(np.where(masks, 1.0, -1.0).astype(np.float32))
    np.testing.assert_array_equal(cc.fill_holes_in_mask_scores(scores, 8).numpy(),
                                  np.asarray(jax_cc.fill_holes_in_mask_scores(
                                      jnp.asarray(scores.numpy()), 8)))
    np.testing.assert_array_equal(cc.remove_small_sparks(scores, 8).numpy(),
                                  np.asarray(jax_cc.remove_small_sparks(
                                      jnp.asarray(scores.numpy()), 8)))
    np.testing.assert_array_equal(cc.mask_to_box(torch.from_numpy(masks)).numpy(),
                                  np.asarray(jax_cc.mask_to_box(jnp.asarray(masks))))



@pytest.mark.parametrize("hole, sprinkle", [(8, 0), (0, 8), (8, 8)])
def test_postprocess_masks_fills_holes_and_sparks(hole, sprinkle):
    """`SAM2Transforms.postprocess_masks` with hole filling and spark removal
    (through `fill_small_components`) then the resize back to the image,
    against the JAX package's, at the fp32 limit."""
    rng = np.random.default_rng(16)
    logits = rng.standard_normal((2, 3, 37, 53)).astype(np.float32)
    args = dict(resolution=64, mask_threshold=0.25, max_hole_area=hole,
                max_sprinkle_area=sprinkle)
    ref = JaxSAM2Transforms(**args).postprocess_masks(jnp.asarray(logits), (50, 70))
    out = SAM2Transforms(**args).postprocess_masks(torch.from_numpy(logits), (50, 70))
    _assert_fp32(ref, out)

# ---------------------------------------------------------------------------
# 9-10. full-width layout, checkpoint loader

def _manifest():
    with open(MANIFEST) as f:
        return {n: tuple(s) for n, s in json.load(f)}


def test_full_width_sam2_matches_the_manifest():
    """`build_sam2(sam2_hiera_l("2.1"))` on the meta device: the 903 names
    and shapes of the released checkpoint, no more, no fewer; none of them
    is an entry the shared loader drops as dead."""
    manifest = _manifest()
    assert len(manifest) == 903
    assert not any(ckpt.is_dead(name) for name in manifest)
    model = build_sam2(sam2_hiera_l("2.1"), device="meta")
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == manifest


@pytest.mark.parametrize("form", ["bare", "wrapped in model", "module. prefix"])
def test_sam2_checkpoint_loader(sam, tmp_path, form):
    """A checkpoint file in each released form loads whole: every entry
    matched, the tensors equal; a wrong shape is reported, not loaded."""
    cfg, _, _, model = sam
    state = {k: v + 1.0 for k, v in model.state_dict().items()}
    wrap = {"bare": state, "wrapped in model": {"model": state},
            "module. prefix": {f"module.{k}": v for k, v in state.items()}}[form]
    path = str(tmp_path / "sam2.pt")
    torch.save(wrap, path)
    fresh = build_sam2(cfg, checkpoint=path, device="cpu", seed=1)
    report = fresh.load_report
    assert len(report["matched"]) == len(state)
    assert not (report["missing"] or report["unused"] or report["shape_mismatch"]
                or report["dropped"])
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k])
    bad = dict(state)
    bad["no_obj_ptr"] = torch.zeros(2, cfg.d_model)
    report = ckpt.load_reference_state(build_sam2(cfg, device="cpu"), bad, log=None)
    assert report["shape_mismatch"] == [
        f"no_obj_ptr: checkpoint (2, {cfg.d_model}) vs model (1, {cfg.d_model})"]
