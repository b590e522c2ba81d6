"""The port's reference-checkpoint loader (`utils/checkpoint.py`) against the
JAX package's converter rules, on the CPU.

The reference layout is the manifest's (2053 names and shapes of the
published IGGT checkpoint), built as meta tensors, so no file is read.  The
JAX package's `iggt_rename` says which names are dead (it maps them to
None); the port keeps the other names as they are.  No tolerance: names,
counts and loaded tensors must be equal.
"""

import argparse
import dataclasses
import json
import os.path as op

import pytest
import torch

from iggt_official_tpu.utils.torch_convert import iggt_rename
from iggt_official_tpu_torch.app.demo import IGGTProcessor
from iggt_official_tpu_torch.config import ModelConfig
from iggt_official_tpu_torch.models.vggt import build_model
from iggt_official_tpu_torch.utils import checkpoint as ckpt

from . import test_torch_helpers  # noqa: F401  (one torch thread per worker)

REPO = op.dirname(op.dirname(op.abspath(__file__)))
MANIFEST = op.join(REPO, "tests", "data", "iggt_state_dict_manifest.json")
SCALED = dict(embed_dim=64, depth=2, num_heads=2, vit_depth=1, img_size=56,
              patch_embed="conv")


def _manifest_state():
    with open(MANIFEST) as f:
        return {n: torch.empty(s, device="meta") for n, s in json.load(f)}


def _forms(state):
    return {"bare": state,
            "wrapped in model": {"model": state, "epoch": 7},
            "module. prefix": {f"module.{k}": v for k, v in state.items()},
            "both": {"model": {f"module.{k}": v for k, v in state.items()}}}


@pytest.mark.parametrize("form", ["bare", "wrapped in model", "module. prefix", "both"])
def test_reference_layout_loads_in_every_form(form):
    """Of the manifest's 2053 entries, the 20 that `iggt_rename` drops are
    dropped, the 394 track-head entries are unused, the other 1639 match the
    full-width model name for name; nothing is missing or mismatched."""
    state = _manifest_state()
    assert len(state) == 2053
    dead = {n for n in state if iggt_rename(n) is None}
    track = {n for n in state if n.startswith("track_head.")}
    assert len(dead) == 20 and len(track) == 394 and not dead & track
    assert {n for n in state if ckpt.is_dead(n)} == dead
    model = build_model(ModelConfig(), device="meta")
    logged = []
    report = ckpt.load_reference_state(model, _forms(state)[form], log=logged.append)
    assert set(report["dropped"]) == dead
    assert set(report["unused"]) == track
    assert set(report["matched"]) == set(state) - dead - track == set(model.state_dict())
    assert len(report["matched"]) == 1639
    assert report["missing"] == [] and report["shape_mismatch"] == []
    assert logged == ["checkpoint: 1639 matched, 0 shape-mismatch, 0 missing, 394 unused, "
                      "20 dropped"]


def test_reference_layout_loads_whole_with_the_track_head():
    """With ``enable_track=True`` the full-width model holds the track head
    under the reference's names (its Sequential heads included): the
    manifest loads as 2033 matched, 0 unused, 20 dropped, 0 missing."""
    state = _manifest_state()
    dead = {n for n in state if iggt_rename(n) is None}
    model = build_model(dataclasses.replace(ModelConfig(), enable_track=True), device="meta")
    logged = []
    report = ckpt.load_reference_state(model, state, log=logged.append)
    assert set(report["dropped"]) == dead
    assert set(report["matched"]) == set(state) - dead == set(model.state_dict())
    assert report["unused"] == [] and report["missing"] == [] and report["shape_mismatch"] == []
    assert logged == ["checkpoint: 2033 matched, 0 shape-mismatch, 0 missing, 0 unused, "
                      "20 dropped"]


def test_processor_loads_a_saved_training_checkpoint(tmp_path):
    """A scaled model's state dict, saved as a DDP training checkpoint (a
    ``module.`` prefix, wrapped in ``"model"`` beside the epoch and the
    script's argparse namespace) with dead entries, a track-head entry and one
    shape mismatch, through `IGGTProcessor(..., device="cpu")`: every other
    tensor lands, the mismatched one keeps the model's, the report says so."""
    cfg = ModelConfig().scaled(**SCALED)
    init = build_model(cfg, "cpu", seed=11).state_dict()   # what the processor builds
    src = {k: v + 1 if v.is_floating_point() else v for k, v in init.items()}
    bad = "camera_head.pose_branch.fc2.weight"
    assert bad in src
    saved = {f"module.{k}": v for k, v in src.items()}
    saved[f"module.{bad}"] = torch.ones(3, 5)
    dead = ("part_head.norm.weight", "part_head.projects.0.weight",
            "aggregator.patch_embed.mask_token",
            "part_head.x.blocks.0.attn.relative_position_index")
    for name in dead:
        saved[f"module.{name}"] = torch.zeros(4)
    saved["module.track_head.feature_extractor.norm.weight"] = torch.zeros(4)
    path = tmp_path / "checkpoint.pth"
    torch.save({"model": saved, "epoch": 3, "args": argparse.Namespace(lr=1e-4)}, path)

    proc = IGGTProcessor(str(path), model_cfg=cfg, device="cpu", seed=11)
    report = proc.load_report
    got = proc.model.state_dict()
    assert sorted(report["dropped"]) == sorted(dead)
    assert report["unused"] == ["track_head.feature_extractor.norm.weight"]
    assert report["missing"] == []
    assert report["shape_mismatch"] == [
        f"{bad}: checkpoint (3, 5) vs model {tuple(src[bad].shape)}"]
    assert set(report["matched"]) == set(src) - {bad}
    for name, value in src.items():
        assert torch.equal(got[name], init[name] if name == bad else value), name
    assert not torch.equal(init[bad], src[bad])


class _Extra:
    """An object that a weights-only read does not know."""


def test_unknown_pickled_objects_are_refused(tmp_path):
    """The weights-only read refuses an object it does not know beside the
    weights, and a checkpoint that holds no dict is refused."""
    path = tmp_path / "odd.pth"
    torch.save({"model": {"w": torch.zeros(2)}, "extra": _Extra()}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        ckpt.read_checkpoint(str(path))
    with pytest.raises(ValueError, match="state dict"):
        ckpt.unwrap([torch.zeros(1)])
