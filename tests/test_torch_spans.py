"""The port's profiler spans (`utils/logging.py::span`) in the forward.

Under `torch.profiler` each request is one ``model.forward`` span holding
``model.trunk`` first, then one span per head that runs; every op the
forward runs sits inside one of those layer spans.  The spans are read from
the profiler's Chrome trace, where the benchmark reads them.  With no
profiler recording, `span` enters no ``record_function``.  The models are
the scaled configuration of `test_torch_model.py` with torch's default
initialization (the seeded init of its full-width heads takes seconds; the
spans do not depend on the weights), the track head cut to one iteration,
on one view.
"""

import bisect
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from iggt_official_tpu_torch.models import vggt as tvggt
from iggt_official_tpu_torch.utils import logging as tlogging

from .test_torch_model import HW, _configs

LAYERS = (tvggt.TRUNK_SPAN, tvggt.CAMERA_SPAN, tvggt.DEPTH_SPAN, tvggt.POINT_SPAN,
          tvggt.TRACK_SPAN, tvggt.PART_SPAN)
VGGT_LAYERS = [tvggt.TRUNK_SPAN, tvggt.CAMERA_SPAN, tvggt.DEPTH_SPAN, tvggt.POINT_SPAN]


def _images(seed):
    return torch.rand((1, 1, *HW, 3), generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def models():
    cfg = _configs("conv", "float32")[0]
    vcfg = dataclasses.replace(cfg, name="vggt", enable_part=False, enable_track=True,
                               track=dataclasses.replace(cfg.track, iters=1))
    torch.manual_seed(0)
    return {"iggt": tvggt.IGGT(cfg).eval().requires_grad_(False),
            "vggt": tvggt.VGGT(vcfg).eval().requires_grad_(False)}


@pytest.fixture(scope="module")
def traced(models, tmp_path_factory):
    """The Chrome trace's complete events of one profiler session: two IGGT
    requests, then VGGT without query points, with them, and ``feat_only``
    (inputs made before the profiler starts)."""
    iggt, vggt = models["iggt"], models["vggt"]
    x = [_images(i) for i in range(3)]
    q = torch.tensor([[[10.0, 12.0], [40.0, 30.0], [60.0, 50.0]]])
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        iggt(x[0])
        iggt(x[1])
        vggt(x[2])
        vggt(x[2], query_points=q)
        vggt(x[2], feat_only=True)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("model.")))
    ops = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e.get("cat") == "cpu_op"]
    return spans, ops


def _inside(intervals, start, end):
    """The interval of ``intervals`` (sorted, not overlapping) holding
    [start, end], or None."""
    i = bisect.bisect_right(intervals, (start, float("inf"))) - 1
    return intervals[i] if i >= 0 and intervals[i][1] >= end else None


def test_one_forward_span_per_request(traced):
    spans, _ = traced
    assert sum(name == tvggt.FORWARD_SPAN for _, _, name in spans) == 5


def test_trunk_first_then_one_span_per_head(traced):
    """IGGT: the part head last; VGGT: no part head, the track head only with
    query points; ``feat_only``: the trunk, the depth and point heads."""
    spans, _ = traced
    forwards = [s for s in spans if s[2] == tvggt.FORWARD_SPAN]
    requests = [[name for s, e, name in spans if f[0] <= s and e <= f[1] and name in LAYERS]
                for f in forwards]
    iggt = VGGT_LAYERS + [tvggt.PART_SPAN]
    assert requests == [iggt, iggt, VGGT_LAYERS, VGGT_LAYERS + [tvggt.TRACK_SPAN],
                        [tvggt.TRUNK_SPAN, tvggt.DEPTH_SPAN, tvggt.POINT_SPAN]]


def test_every_op_nests_under_a_layer_span(traced):
    spans, ops = traced
    layers = [s for s in spans if s[2] in LAYERS]
    assert len(ops) > 1000
    outside = sorted({name for s, e, name in ops if _inside(layers, s, e) is None})
    assert not outside, outside


def test_span_enters_record_function_only_under_a_profiler(models, monkeypatch):
    entered = []
    real = tlogging.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tlogging, "record_function", counting)
    x = _images(3)
    with torch.inference_mode():
        models["vggt"](x)
    with tlogging.span("outside"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tlogging.span("inside"):
            pass
    assert entered == ["inside"]
