"""The readers of the program's spans (`trunk_ms_per_view.fwd`,
`heads_ms_per_view.fwd`, `heads_idle_ms_per_view.fwd`) on a synthetic
Chrome trace passed through `trace.from_events`: device operations launched
under the trunk's span, under head spans and outside both, with known gaps;
the values worked out by hand, and None on the same trace without spans."""

from __future__ import annotations

import pytest

from perfbench import harness, trace

READERS = ("trunk_ms_per_view.fwd", "heads_ms_per_view.fwd", "heads_idle_ms_per_view.fwd")
VIEWS = 2


def reader(name):
    return harness.load_file(harness.BENCH_DIR / "metrics" / f"{name}.py",
                             "perfbench_metric_" + name.replace(".", "_")).read


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(op, ts, corr, start, dur):
    """A CPU op at ``ts`` launching, through a runtime call, a kernel that
    runs [start, start + dur] on the device (microseconds)."""
    return [{"ph": "X", "cat": "cpu_op", "name": op, "ts": ts, "dur": 4, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts + 1,
             "dur": 1, "tid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"kernel_{corr}", "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def events(spans=True):
    """Device time in microseconds, window [0, 1000]:

    - trunk: kernel 1 [100, 200] (the gap [0, 100] before it is the trunk's);
    - camera head: kernel 2 [260, 300], after a gap of 60;
    - depth head: kernel 3 [300, 350], no gap;
    - part head: kernel 4 [400, 450], after a gap of 50;
    - outside the forward: kernel 5 [500, 520], after a gap of 50; the tail
      [520, 1000] counts for no layer.
    """
    ev = [_span(trace.WINDOW_SPAN, 0, 1000)]
    if spans:
        ev += [_span("model.forward", 10, 890), _span("model.trunk", 20, 280),
               _span("model.camera_head", 310, 90), _span("model.depth_head", 410, 90),
               _span("model.part_head", 510, 290)]
    ev += _launch("aten::mm", 30, 1, 100, 100)
    ev += _launch("aten::mul", 320, 2, 260, 40)
    ev += _launch("aten::convolution", 420, 3, 300, 50)
    ev += _launch("aten::cat", 520, 4, 400, 50)
    ev += _launch("aten::isfinite", 950, 5, 500, 20)
    return ev


@pytest.mark.parametrize("name,want", [
    ("trunk_ms_per_view.fwd", 1e-3 * 100 / VIEWS),
    ("heads_ms_per_view.fwd", 1e-3 * (40 + 50 + 50) / VIEWS),
    ("heads_idle_ms_per_view.fwd", 1e-3 * (60 + 50) / VIEWS),
])
def test_reader_on_spans(name, want):
    tr = trace.from_events(events())
    assert reader(name)(tr, {"views": VIEWS}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_reads_nothing(name):
    tr = trace.from_events(events(spans=False))
    assert tr.busy_s > 0
    assert reader(name)(tr, {"views": VIEWS}) is None
