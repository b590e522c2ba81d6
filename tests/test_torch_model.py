"""The PyTorch port's IGGT forward and scene processor against the JAX package,
plus the port's layout, weight carry and import hygiene.

Tolerances (relative to each output's magnitude): fp32 trunk 1e-3 (errors
seen are ~3e-6: fp32 throughout, summation order differs); bf16 trunk 3e-2
(errors seen are ~7e-3: bf16 keeps 8 mantissa bits and the two frameworks
round at different points -- JAX's CPU attention rounds its logits to bf16,
flax rounds each dense output before adding the bias).
"""

import ast
import dataclasses
import json
import os
import os.path as op

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from iggt_official_tpu.config import ModelConfig as JModelConfig
from iggt_official_tpu.geometry import (
    pose_encoding_to_extri_intri as jpose_decode,
    unproject_depth_map_to_point_map as junproject,
)
from iggt_official_tpu.models.vggt import IGGT as JIGGT
from iggt_official_tpu.ops.flash_attention import attention as jattention
from iggt_official_tpu.utils.images import load_and_preprocess_images as jload
from iggt_official_tpu.utils.torch_convert import iggt_rename, torch_state_dict_to_flax
from iggt_official_tpu_torch.app.demo import IGGTProcessor
from iggt_official_tpu_torch.config import ModelConfig, RuntimeConfig
from iggt_official_tpu_torch.models.vggt import build_model
from iggt_official_tpu_torch.utils.convert import jax_params_to_torch_state_dict

from .test_torch_helpers import jit, load_numpy, perturbed_state_dict, rel_err, to_flax

REPO = op.dirname(op.dirname(op.abspath(__file__)))
MANIFEST = op.join(REPO, "tests", "data", "iggt_state_dict_manifest.json")
SCALED = dict(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56)
HW = (56, 70)
OUTPUTS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf",
           "part_feat")
TOL = {"float32": 1e-3, "bfloat16": 3e-2}
_JAX_FORWARD = {}


def _configs(patch_embed, trunk):
    kw = dict(SCALED, patch_embed=patch_embed)
    return (dataclasses.replace(ModelConfig().scaled(**kw), trunk_dtype=trunk),
            dataclasses.replace(JModelConfig().scaled(**kw), trunk_dtype=trunk))


def _jax_forward(patch_embed, trunk):
    """IGGT.apply(..., attn_fn=attention) as the JAX demo runs it, jitted once
    per configuration in this process."""
    key = (patch_embed, trunk)
    if key not in _JAX_FORWARD:
        jmodel = JIGGT(_configs(patch_embed, trunk)[1])
        _JAX_FORWARD[key] = jit(lambda p, x: jmodel.apply(p, x, attn_fn=jattention))
    return _JAX_FORWARD[key]


def _port_model(patch_embed, trunk, seed=0):
    model = build_model(_configs(patch_embed, trunk)[0], device="cpu", seed=seed)
    sd = perturbed_state_dict(model, seed + 100)
    return load_numpy(model, sd), sd


@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("patch_embed", ["conv", "dinov2_vitl14_reg"])
def test_scaled_iggt_matches_jax(patch_embed, trunk):
    model, sd = _port_model(patch_embed, trunk)
    imgs = np.random.default_rng(1).uniform(0, 1, (1, 2, *HW, 3)).astype(np.float32)
    ref = _jax_forward(patch_embed, trunk)(to_flax(sd), jnp.asarray(imgs))
    with torch.inference_mode():
        out = model(torch.from_numpy(imgs))
    for k in OUTPUTS:
        assert tuple(out[k].shape) == tuple(ref[k].shape), k
        assert out[k].dtype == torch.float32, k
        assert rel_err(ref[k], out[k].numpy()) < TOL[trunk], k
    assert len(out["pose_enc_list"]) == 4


def test_processor_scene_matches_jax(tmp_path):
    """IGGTProcessor(device="cpu") on a 2-view scene of seeded PNGs, weights
    from a saved port state dict, against JAX IGGT.apply -> pose decode ->
    unprojection on the same weights and the same loaded images."""
    cfg = _configs("conv", "float32")[0]
    _, sd = _port_model("conv", "float32", seed=3)
    weights = tmp_path / "weights.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, weights)
    scene = tmp_path / "scene" / "images"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(4)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)).save(
            scene / f"{i:03d}.png")

    proc = IGGTProcessor(str(weights), model_cfg=cfg,
                         runtime=RuntimeConfig(image_size=(HW[1], HW[0])), device="cpu")
    preds = proc.process_scene(str(tmp_path / "scene"), str(tmp_path / "out"))
    assert op.exists(tmp_path / "out" / "predictions.npz")

    images = jload(sorted(str(p) for p in scene.iterdir()), mode="resize",
                   resize_target_size=(HW[1], HW[0]))
    np.testing.assert_array_equal(preds["images"], images)
    out = _jax_forward("conv", "float32")(to_flax(sd), jnp.asarray(images[None]))
    extri, intri = jpose_decode(out["pose_enc"], HW)
    ref = {"extrinsic": extri[0], "intrinsic": intri[0], "pose_enc": out["pose_enc"],
           "world_points_from_depth": junproject(out["depth"][0], extri[0], intri[0])}
    for k in ("depth", "depth_conf", "world_points", "world_points_conf", "part_feat"):
        ref[k] = out[k][0]
    for k, v in ref.items():
        assert preds[k].shape == v.shape, k
        assert rel_err(v, preds[k]) < TOL["float32"], k


def test_full_width_state_dict_is_the_reference_layout():
    """ModelConfig() built on the meta device: names and shapes equal the
    reference checkpoint's, minus the track head and the 20 entries the
    JAX converter drops (dead part-head projections, mask token, window
    index buffers)."""
    with open(MANIFEST) as f:
        manifest = json.load(f)
    want = {n: tuple(s) for n, s in manifest
            if not n.startswith("track_head.") and iggt_rename(n) is not None}
    assert len(want) == 1639
    model = build_model(ModelConfig(), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def test_weight_carry_round_trips_exactly():
    """JAX params -> port state dict (`jax_params_to_torch_state_dict`) -> JAX
    params (the JAX package's `torch_state_dict_to_flax`) is the identity,
    and the carried state dict loads strictly into the port's model."""
    model, sd = _port_model("dinov2_vitl14_reg", "float32", seed=5)
    params = torch_state_dict_to_flax(sd, rename=iggt_rename)
    carried = jax_params_to_torch_state_dict({"params": params})
    assert set(carried) == set(model.state_dict())
    model.load_state_dict(carried, strict=True)
    back = torch_state_dict_to_flax({k: v.numpy() for k, v in carried.items()},
                                    rename=iggt_rename)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ModelConfig().scaled(**SCALED, patch_embed="conv"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IGGTProcessor(model_cfg=ModelConfig().scaled(**SCALED, patch_embed="conv"))


def _python_sources():
    pkg = op.join(REPO, "iggt_official_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield op.join(root, name)
    yield op.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    # nor sklearn or matplotlib, which the card machine does not have
    banned = ("jax", "jaxlib", "flax", "iggt_official_tpu", "sklearn", "matplotlib")
    sources = list(_python_sources())
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"
