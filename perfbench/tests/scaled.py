"""Scaled cells for the benchmark's CPU tests: the real configuration and
traffic files at the widths of a test run, the structure of each cell kept."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path


CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

SCALED = {"embed_dim": 64, "depth": 2, "num_heads": 2, "img_size": 56}


def scaled_model(model: dict, trunk_dtype: str = None) -> dict:
    """The configuration's model group at test widths, every switch kept."""
    from iggt_official_tpu_torch.config import ModelConfig

    cfg = ModelConfig(name=model["name"], enable_part=model["enable_part"],
                      enable_track=model["enable_track"],
                      trunk_dtype=model["trunk_dtype"],
                      head_dtype=model["head_dtype"]).scaled(**SCALED)
    if trunk_dtype:
        cfg = dataclasses.replace(cfg, trunk_dtype=trunk_dtype)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def scale_cell(config: dict, traffic: dict, views: int = 3, hw=(56, 42)) -> None:
    config["model"] = scaled_model(config["model"])
    traffic.update(views=views, height=hw[0], width=hw[1], warmup_requests=1,
                   traced_requests=2, check_among=2)
