"""The names of the spans the program opens in its forward under a profiler
(`iggt_official_tpu_torch/models/vggt.py`), as the metric readers find them
in a device operation's launch stack (`trace.py`).  A program without them
gives the readers nothing to read."""

TRUNK = "model.trunk"
HEADS = ("model.camera_head", "model.depth_head", "model.point_head", "model.track_head",
         "model.part_head")


def in_heads(stack) -> bool:
    return any(s in HEADS for s in stack)
