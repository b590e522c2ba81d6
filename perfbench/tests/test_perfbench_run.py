"""run.py without a card, the trace reduction, and whole runs of each cell on
the CPU at test widths (the harness's look for a card skipped): sound runs
come out correct, runs with the timed path broken underneath and the control
(the reference one precision down in the program's place) do not."""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, program, trace
from perfbench.reference import precision
from perfbench.tests.scaled import CHECKOUT, scale_cell

FWD = ("iggt.fwd.8x518", "vggt.fwd.64x504")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
SEED = 2**31 + 12345
STAND_IN = "jax"    # a stub package of this name, made in the test's own directory


def test_run_without_a_card_exits_nonzero():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", FWD[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 100, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 105, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "ts": 106, "dur": 8, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 107, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 151, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "conv_kernel", "ts": 110, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 160, "dur": 20,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 300, "dur": 20,
         "args": {"correlation": 9}},
    ]
    tr = trace.from_events(ev)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.ops[0].stack == (trace.WINDOW_SPAN, "aten::conv2d", "aten::convolution")
    conv = tr.time_of(lambda name, stack: "aten::convolution" in stack)
    assert conv == pytest.approx(30e-6)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["conv_kernel", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert gaps["aten::conv2d > aten::convolution"] == pytest.approx(10e-6)
    assert gaps["after the last device op"] == pytest.approx(20e-6)


def test_idle_and_mfu_read_the_untraced_window():
    """The device's busy seconds from the traced window, set against the
    seconds the same requests took without the profiler."""
    from perfbench.flops import PEAK

    def reader(name):
        return harness.load_file(harness.BENCH_DIR / "metrics" / f"{name}.py",
                                 "perfbench_metric_" + name.replace(".", "_")).read

    tr = trace.Trace([], (0.0, 3.0), [(0.0, 1.2), (1.5, 2.1)])
    facts = {"untraced_window_s": 2.0, "requests": 4, "flops_per_request": 1e12}
    assert reader("device_idle_share.fwd")(tr, facts) == pytest.approx(10.0)
    assert reader("mfu.fwd")(tr, facts) == pytest.approx(100 * 4e12 / 2.0 / PEAK["bf16_flops"])
    for name in ("device_idle_share.fwd", "mfu.fwd"):
        assert reader(name)(tr, dict(facts, untraced_window_s=None)) is None


def run_scaled(bench, workload, traced=False, seconds=0.5):
    return harness.run_cell(bench, workload, SEED, seconds, traced, time.perf_counter(),
                            torch.device("cpu"), override=scale_cell)


def wrap_program(monkeypatch, wrapper):
    """Break the timed path underneath: every model the harness builds runs
    through ``wrapper(model, images, kwargs)``."""
    build = program.build_program

    def broken(*args, **kwargs):
        model = build(*args, **kwargs)
        forward = model.forward
        model.forward = lambda images, **kw: wrapper(forward, images, kw)
        return model

    monkeypatch.setattr(program, "build_program", broken)


@pytest.mark.parametrize("workload", FWD)
def test_fwd_cell_sound_run_is_correct(bench, workload):
    out = run_scaled(bench, workload, traced=True)
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    assert list(out) == list(RESULT_KEYS)
    assert set(out["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    assert set(out["checks"]) == set(harness.cell_spec(bench, workload)[0]["limits"])


def _stale():
    """Every request answered with the first one's outputs."""
    first = []

    def wrapper(forward, images, kw):
        out = forward(images, **kw)
        first[:1] = first[:1] or [out]
        return first[0]

    return wrapper


def _half_views(forward, images, kw):
    h = images.shape[1] // 2
    return forward(torch.cat([images[:, :h], images[:, :images.shape[1] - h]], 1), **kw)


def _answer_altered(forward, images, kw):
    out = dict(forward(images, **kw))
    depth = out["depth"].clone()
    depth.view(-1)[7] += 0.01 * depth.abs().max()
    out["depth"] = depth
    return out


@pytest.mark.parametrize("workload", FWD)
@pytest.mark.parametrize("fault", ["stale", "half_views", "answer_altered", "token_altered"])
def test_fwd_cell_broken_path_is_not_correct(bench, monkeypatch, workload, fault):
    if fault == "token_altered":
        from iggt_official_tpu_torch.models.aggregator import Aggregator

        agg_forward = Aggregator.forward

        def altered(self, *args, **kwargs):
            outputs, psi = agg_forward(self, *args, **kwargs)
            outputs[-1] = outputs[-1].clone()
            outputs[-1][:, 0, psi + 3] *= 1.5
            return outputs, psi

        monkeypatch.setattr(Aggregator, "forward", altered)
    else:
        wrap_program(monkeypatch, {"stale": _stale(), "half_views": _half_views,
                                   "answer_altered": _answer_altered}[fault])
    out = run_scaled(bench, workload)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", FWD)
def test_control_is_not_correct(bench, workload):
    """The reference one precision below the configuration, in the program's
    place, fails at least one of the cell's limits."""
    cell, config, traffic = harness.cell_spec(bench, workload)
    scale_cell(config, traffic)
    entry = harness.load_file(harness.BENCH_DIR / "entries" / f"{traffic['entry']}.py",
                              "perfbench_entry_control")
    state = entry.setup({"config": config, "traffic": traffic, "seed": SEED,
                         "device": torch.device("cpu"), "cell": cell})
    entry.release(state)
    checks = entry.check(state, **entry.control(config, precision))
    assert any(v > limit for _, v, limit in checks if limit is not None), checks


@pytest.mark.parametrize("where", ["metric_reader", "check"])
def test_jax_loaded_after_the_window_gives_no_result(bench, monkeypatch, tmp_path, where):
    """A module named ``jax`` imported by a metric reader, or by the check,
    after the window has closed: the run prints no result (run.py exits 4)."""
    (tmp_path / STAND_IN).mkdir()
    (tmp_path / STAND_IN / "__init__.py").write_text('"""A stand-in named jax."""\n')
    monkeypatch.syspath_prepend(str(tmp_path))
    assert STAND_IN not in sys.modules
    load_file = harness.load_file

    def loading_jax(path, name):
        module = load_file(path, name)
        if where == "metric_reader" and name.startswith("perfbench_metric_"):
            read = module.read
            module.read = lambda tr, facts: (importlib.import_module(STAND_IN), read(tr, facts))[1]
        if where == "check" and name.startswith("perfbench_entry_"):
            check = module.check
            module.check = lambda state: (importlib.import_module(STAND_IN), check(state))[1]
        return module

    monkeypatch.setattr(harness, "load_file", loading_jax)
    try:
        out = run_scaled(bench, FWD[0], traced=where == "metric_reader")
        assert sys.modules[STAND_IN].__file__.startswith(str(tmp_path))
    finally:
        sys.modules.pop(STAND_IN, None)
    assert out is None


def test_result_line_is_json(bench):
    out = run_scaled(bench, FWD[0])
    line = json.dumps(out)
    assert json.loads(line)["device"]["count"] == 1
