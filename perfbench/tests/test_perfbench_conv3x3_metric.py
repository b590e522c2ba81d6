"""The reader of the program's ``ops.conv3x3`` span
(`conv3x3_ms_per_view.fwd`) on a synthetic Chrome trace passed through
`trace.from_events`: the weight split and the convolution launched inside
the span, nested in a head span, beside a cuDNN convolution and a trunk
kernel outside it; the value worked out by hand, and None on the same trace
without the span (as a program without the kernel gives)."""

from __future__ import annotations

import pytest

from perfbench import harness, trace

NAME = "conv3x3_ms_per_view.fwd"
VIEWS = 2


def reader():
    return harness.load_file(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                             "perfbench_metric_" + NAME.replace(".", "_")).read


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(ts, corr, start, dur, op=None):
    """A launch at ``ts`` (inside CPU op ``op`` when given) of a kernel that
    runs [start, start + dur] on the device (microseconds)."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts + 1,
           "dur": 1, "tid": 1, "args": {"correlation": corr}},
          {"ph": "X", "cat": "kernel", "name": f"kernel_{corr}", "ts": start, "dur": dur,
           "args": {"correlation": corr}}]
    if op:
        ev.insert(0, {"ph": "X", "cat": "cpu_op", "name": op, "ts": ts, "dur": 4, "tid": 1})
    return ev


def events(with_span=True):
    """Device time in microseconds, window [0, 1000]:

    - trunk: kernel 1 [100, 200];
    - depth head, inside ``ops.conv3x3``: the weight split (kernel 2,
      [300, 310]) and the convolution (kernel 3, [310, 410]), launched with no
      aten op open, as the program's ctypes launches are;
    - depth head, a cuDNN convolution outside the span: kernel 4 [420, 470].
    """
    ev = [_span(trace.WINDOW_SPAN, 0, 1000), _span("model.forward", 10, 890),
          _span("model.trunk", 20, 180), _span("model.depth_head", 300, 300)]
    if with_span:
        ev.append(_span("ops.conv3x3", 310, 40))
    ev += _launch(30, 1, 100, 100, "aten::mm")
    ev += _launch(320, 2, 300, 10)
    ev += _launch(330, 3, 310, 100)
    ev += _launch(400, 4, 420, 50, "aten::convolution")
    return ev


def test_reader_on_span():
    tr = trace.from_events(events())
    assert reader()(tr, {"views": VIEWS}) == pytest.approx(1e-3 * (10 + 100) / VIEWS)


def test_reader_without_span_reads_nothing():
    tr = trace.from_events(events(with_span=False))
    assert tr.busy_s > 0
    assert reader()(tr, {"views": VIEWS}) is None
