"""The port's SAM2 video path (`sam2/video_predictor.py`, `sam2/video_io.py`,
`sam2/benchmark.py`) against the JAX package's, on the CPU.

`SAM2Config().scaled()` (image 64) with the JAX package's seeded init of
`SAM2Base.init_all` (jitted once per module), carried into the port by
`utils/convert.py::jax_sam2_params_to_torch_state_dict` and loaded strictly;
the object-score head's output bias is raised by 8 in both packages, so that
random weights predict objects and the memory carries non-empty masks.  One
JAX predictor serves the module (its jitted steps compile once).  Frames are
seeded 48x64 uint8 noise.  Tolerances: mask logits within 1e-5 of max|ref|
(the frameworks sum in other orders), binary masks equal except where the
JAX logit lies within 1e-4 of the threshold; the port's batch loop against
its streaming loop within rtol 1e-4 / atol 2e-4 (the JAX package's own bar
for its scan against its stream).  JPEG frames: PIL's decode (the port)
against cv2's (the JAX package) of the same files, exactly (both are
libjpeg-turbo with its default IDCT and upsampling here; measured max
difference 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggt_official_tpu.sam2 import video_io as jax_video_io
from iggt_official_tpu.sam2.base import SAM2Base as JaxSAM2
from iggt_official_tpu.sam2.transforms import SAM2Transforms as JaxSAM2Transforms
from iggt_official_tpu.sam2.video_predictor import SAM2VideoPredictor as JaxVideoPredictor
from iggt_official_tpu_torch.sam2 import benchmark, video_io
from iggt_official_tpu_torch.sam2.base import SAM2Base
from iggt_official_tpu_torch.sam2.config import SAM2Config
from iggt_official_tpu_torch.sam2.transforms import SAM2Transforms
from iggt_official_tpu_torch.sam2.video_predictor import SAM2VideoPredictor
from iggt_official_tpu_torch.utils.convert import jax_sam2_params_to_torch_state_dict

from .test_torch_helpers import jit, rel_err

FP32 = 1e-5
MASK_MARGIN = 1e-4
HW = (48, 64)


@pytest.fixture(scope="module")
def video():
    """(JAX predictor, port model) for `SAM2Config().scaled()`, same weights."""
    cfg = SAM2Config().scaled()
    jm = JaxSAM2(cfg)
    img = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = jit(lambda: jm.init(jax.random.PRNGKey(5), img, method=JaxSAM2.init_all))()
    head = params["params"]["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]
    params["params"]["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"] = dict(
        head, bias=head["bias"] + 8.0)
    model = SAM2Base(cfg).eval().requires_grad_(False)
    model.load_state_dict(jax_sam2_params_to_torch_state_dict(params), strict=True)
    return JaxVideoPredictor(jm, params), model


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, HW + (3,), dtype=np.uint8) for _ in range(n)]


def _assert_masks(ref, out):
    """Logits within FP32 of max|ref|; thresholded masks equal off the margin."""
    ref = np.asarray(ref)
    out = out.detach().cpu().numpy()
    assert ref.shape == out.shape
    assert rel_err(ref, out) <= FP32
    differ = (ref > 0) != (out > 0)
    assert not (differ & (np.abs(ref) > MASK_MARGIN)).any()


def _prompt_both(jp, pp, frames, prompts):
    """init_state on both predictors and the same prompts; each prompt is
    (frame, obj, kwargs).  Returns the two states."""
    js, ps = jp.init_state(frames), pp.init_state(frames)
    for frame, obj, kw in prompts:
        rf, rids, rmask = jp.add_new_points_or_box(js, frame_idx=frame, obj_id=obj, **kw)
        f, ids, mask = pp.add_new_points_or_box(ps, frame_idx=frame, obj_id=obj, **kw)
        assert (f, ids) == (rf, rids)
        _assert_masks(rmask, mask)
    return js, ps


def _point(x, y):
    return {"points": np.array([[x, y]]), "labels": np.array([1])}


TWO_OBJECTS = [(0, 1, _point(30.0, 20.0)), (0, 2, _point(10.0, 40.0))]


def test_prompts_point_box_and_kept_points_match_jax(video):
    """A point, a box, and a second click kept with `clear_old_points=False`:
    each prompt's mask, and the conditioning output (memory features, object
    pointer, score) stored for the object."""
    jp, model = video
    pp = SAM2VideoPredictor(model)
    prompts = [(0, 1, _point(30.0, 20.0)),
               (0, 2, {"box": np.array([8.0, 6.0, 40.0, 30.0])}),
               (0, 1, dict(_point(50.0, 10.0), clear_old_points=False))]
    js, ps = _prompt_both(jp, pp, _frames(0, 2), prompts)
    assert ps["point_inputs_per_obj"][1][0]["point_coords"].shape == (1, 2, 2)
    for obj in (1, 2):
        ref, out = js["cond_frame_outputs"][obj][0], ps["cond_frame_outputs"][obj][0]
        for key in ("maskmem_features", "maskmem_pos_enc", "obj_ptr", "object_score_logits"):
            assert rel_err(ref[key], out[key].numpy()) <= FP32, key


@pytest.mark.parametrize("mode", ["forward", "reverse", "max_frames"])
def test_propagate_in_video_matches_jax(video, mode):
    """Streaming propagation over 5 frames with 2 objects: forward from frame
    0, in reverse from frame 4, and forward at most 2 frames past the prompt."""
    jp, model = video
    pp = SAM2VideoPredictor(model)
    frames = _frames(1, 5)
    start = 4 if mode == "reverse" else 0
    prompts = [(start, obj, kw) for _, obj, kw in TWO_OBJECTS]
    js, ps = _prompt_both(jp, pp, frames, prompts)
    kw = {"reverse": True} if mode == "reverse" else (
        {"max_frame_num_to_track": 2} if mode == "max_frames" else {})
    ref = list(jp.propagate_in_video(js, **kw))
    out = list(pp.propagate_in_video(ps, **kw))
    want = {"forward": [0, 1, 2, 3, 4], "reverse": [4, 3, 2, 1, 0], "max_frames": [0, 1, 2]}
    assert [f for f, _, _ in out] == [f for f, _, _ in ref] == want[mode]
    for (_, rids, rmasks), (_, ids, masks) in zip(ref, out):
        assert ids == rids == [1, 2]
        _assert_masks(rmasks, masks)
    assert sorted(ps["non_cond_frame_outputs"][1]) == sorted(js["non_cond_frame_outputs"][1])


def test_propagate_batch_matches_jax_and_streaming(video):
    """The ring-buffer batch loop against the JAX package's scan (1e-5 of
    max|ref|) and against the port's own streaming loop (the JAX package's
    rtol 1e-4 / atol 2e-4), with its bookkeeping laid out as the JAX package's."""
    jp, model = video
    pp = SAM2VideoPredictor(model)
    frames = _frames(2, 5)
    js, ps = _prompt_both(jp, pp, frames, TWO_OBJECTS)
    ref = list(jp.propagate_in_video_batch(js))
    out = list(pp.propagate_in_video_batch(ps))
    _, ps_stream = _prompt_both(jp, pp, frames, TWO_OBJECTS)
    stream = list(pp.propagate_in_video(ps_stream))
    assert [f for f, _, _ in out] == [f for f, _, _ in ref] == [f for f, _, _ in stream]
    for (_, _, rmasks), (_, ids, masks), (_, _, smasks) in zip(ref, out, stream):
        assert ids == [1, 2]
        _assert_masks(rmasks, masks)
        np.testing.assert_allclose(masks.numpy(), smasks.numpy(), rtol=1e-4, atol=2e-4)
    nc = ps["non_cond_frame_outputs"][1]
    assert sorted(nc) == sorted(ps_stream["non_cond_frame_outputs"][1]) == [1, 2, 3, 4]
    assert nc[2]["obj_ptr"].ndim == 1
    ref_nc = js["non_cond_frame_outputs"][1][2]
    for key in ("maskmem_features", "obj_ptr"):
        assert tuple(nc[2][key].shape) == np.asarray(ref_nc[key]).shape


def test_batch_falls_back_to_streaming_on_other_prompt_frames(video):
    """Objects prompted on different frames: the batch API runs the
    streaming loop, as the JAX package's does, and yields every frame."""
    jp, model = video
    pp = SAM2VideoPredictor(model)
    prompts = [(0, 1, _point(30.0, 20.0)), (1, 2, _point(10.0, 40.0))]
    js, ps = _prompt_both(jp, pp, _frames(3, 3), prompts)
    ref = list(jp.propagate_in_video_batch(js))
    out = list(pp.propagate_in_video_batch(ps))
    assert [f for f, _, _ in out] == [f for f, _, _ in ref] == [0, 1, 2]
    for (_, _, rmasks), (_, _, masks) in zip(ref, out):
        _assert_masks(rmasks, masks)


def test_feature_cache_is_bounded_as_in_jax(video):
    """Streaming over 18 frames keeps at most 2 * num_maskmem + 2 = 16 frames'
    features, evicting the oldest, the same keys as the JAX package's."""
    jp, model = video
    pp = SAM2VideoPredictor(model)
    js, ps = _prompt_both(jp, pp, _frames(4, 18), TWO_OBJECTS[:1])
    ref = list(jp.propagate_in_video(js))
    out = list(pp.propagate_in_video(ps))
    bound = 2 * model.cfg.num_maskmem + 2
    assert len(ps["cached_features"]) == bound
    assert sorted(ps["cached_features"]) == sorted(js["cached_features"]) == list(
        range(18 - bound, 18))
    _assert_masks(ref[-1][2], out[-1][2])


@pytest.fixture
def jpeg_dir(tmp_path):
    from PIL import Image

    for i, frame in enumerate(_frames(5, 5)):
        Image.fromarray(frame).save(tmp_path / f"{i}.jpg", quality=90)
    (tmp_path / "notes.txt").write_text("not a frame")
    return str(tmp_path)


def test_jpeg_frames_match_jax_decode(jpeg_dir):
    """Numeric listing, PIL decode against the JAX package's cv2 decode of the
    same files (exactly equal), and the frame sources' device stacks (sync and
    async, chunks of 2) equal to the JAX package's."""
    paths = video_io.list_jpeg_frames(jpeg_dir)
    assert paths == jax_video_io.list_jpeg_frames(jpeg_dir)
    assert [os.path.basename(p) for p in paths] == [f"{i}.jpg" for i in range(5)]
    for p in paths:
        ref = jax_video_io._decode_image(p)
        out = video_io.decode_image(p)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() == 0
    jt, pt = JaxSAM2Transforms(64, 0.0), SAM2Transforms(64, 0.0)
    ref_src = jax_video_io.load_frame_source(jpeg_dir, jt)
    for async_loading in (False, True):
        src = video_io.load_frame_source(jpeg_dir, pt, torch.device("cpu"),
                                         async_loading_frames=async_loading, chunk=2)
        assert src.num_frames == 5 and src.orig_hw == HW
        for i in (3, 0, 4, 1, 2):
            np.testing.assert_array_equal(src.get(i).numpy(), np.asarray(ref_src.get(i)))


def test_mp4_frames_match_jax(tmp_path):
    """MP4 through cv2 in both packages: the same decoded frames."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (HW[1], HW[0]))
    for frame in _frames(6, 4):
        writer.write(frame[..., ::-1])
    writer.release()
    ref = jax_video_io.decode_video_frames(path)
    out = video_io.decode_video_frames(path)
    assert len(out) == len(ref) == 4
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    src = video_io.load_frame_source(path, SAM2Transforms(64, 0.0), torch.device("cpu"))
    assert src.num_frames == 4 and src.orig_hw == HW


def test_benchmark_entry_point_runs_on_the_cpu(capsys):
    """`python -m iggt_official_tpu_torch.sam2.benchmark --tiny --device cpu`
    (both loops) prints its time and FPS."""
    for extra in ([], ["--streaming", "--warmup", "1"]):
        fps = benchmark.main(["--tiny", "--image_size", "64", "--size", "48", "--frames", "3",
                              "--device", "cpu"] + extra)
        assert fps > 0
    out = capsys.readouterr().out
    assert out.count("FPS:") == 2 and "over 3 frames" in out
