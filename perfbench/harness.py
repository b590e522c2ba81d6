"""One run of one cell: set-up, the measured window, the metrics, the check.

`run_cell` is driven by data: the cell's entry in ``BENCHMARK.json`` names a
configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); the mix names the entry that drives
the window (``perfbench/entries/<entry>.py``), and each per-layer metric is
read by ``perfbench/metrics/<metric>.py``.  Adding a cell, a configuration
or a metric adds files; none of this module changes.

An entry module provides

- ``setup(ctx) -> state``: builds the program from the seed and warms up
  every shape of the window;
- ``window(state, done)``: runs requests until ``done(count, elapsed_s)``;
  each one ends in a device synchronize.  A traced run calls it three
  times: the traced requests without the profiler (their host seconds go
  to the metric readers as ``untraced_window_s``), one request as the
  profiler's warm-up, then the traced requests under it; what the entry
  reports (requests, time, launch counts) is its last call's;
- ``end_to_end(state) -> {metric: value}`` and ``facts(state)`` (what the
  metric readers read besides the trace);
- ``release(state)``: frees the program's device state;
- ``check(state) -> [(name, value, limit)]``: the comparison with the plain
  reference, after the window; a number above its limit is not correct, one
  with the limit None is printed and not compared.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench import trace as trace_mod

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "iggt_official_tpu")


def load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: Dict, workload: str) -> Tuple[Dict, Dict, Dict]:
    """(cell entry, configuration file, traffic file) of ``workload``; the
    cell's check limits (``perfbench/limits/<workload>.json``) go into the
    cell entry's copy under ``limits``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = dict(cells[workload], limits=read_json(BENCH_DIR / "limits" / f"{workload}.json"))
    config = read_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(bench: Dict, kind: str, workload: str) -> List[Dict]:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_loaded() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def run_cell(bench: Dict, workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device: torch.device, chips: int = 1,
             override: Optional[Callable[[Dict, Dict], None]] = None) -> Optional[Dict]:
    """One run; returns the result line's object, or None when the run may
    print no result (JAX or the JAX package loaded by the time it ends).  ``override(config,
    traffic)`` may edit the two files' contents in place before anything is
    built (the CPU tests run a scaled cell)."""
    cell, config, traffic = cell_spec(bench, workload)
    if override is not None:
        override(config, traffic)
    entry = load_file(BENCH_DIR / "entries" / f"{traffic['entry']}.py",
                      f"perfbench_entry_{traffic['entry']}")
    ctx = {"config": config, "traffic": traffic, "seed": seed, "device": device,
           "cell": cell}
    state = entry.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"{workload}: set-up {setup_s:.3f} s")

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        n_traced = traffic["traced_requests"]
        # The traced requests once without the profiler: its host cost idles
        # the device in the traced window, so the idle share and the FLOP
        # rate are read against these seconds.
        t = time.perf_counter()
        entry.window(state, lambda count, elapsed: count >= n_traced)
        untraced_s = time.perf_counter() - t
        prof = profile(activities=activities)
        prof.__enter__()
        # One request under the profiler before the window's span opens: the
        # profiler's own start-up lands on it, outside what the metrics read.
        entry.window(state, lambda count, elapsed: count >= 1)
        with record_function(trace_mod.WINDOW_SPAN):
            entry.window(state, lambda count, elapsed: count >= n_traced)
        prof.__exit__(None, None, None)
    else:
        entry.window(state, lambda count, elapsed: elapsed >= seconds)

    mem_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    result_metrics: Dict[str, Dict] = {}
    breakdown = None
    device_info: Dict = {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu",
                         "count": chips, "memory_peak_bytes": int(mem_peak)}
    facts = entry.facts(state)
    if traced:
        facts["untraced_window_s"] = untraced_s
        tr = trace_mod.from_profiler(prof)
        del prof
        if tr.busy_s <= 0:
            log("the traced window recorded no device operation")
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = trace_mod.breakdown(tr)
        for m in metrics_of(bench, "per_layer", workload):
            reader = load_file(BENCH_DIR / "metrics" / f"{m['name']}.py",
                               "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(tr, facts)
            if value is None:
                log(f"{m['name']}: nothing to read")
                continue
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(entry.end_to_end(state), setup_s=setup_s)
        for m in metrics_of(bench, "end_to_end", workload):
            if m["name"] not in values:
                raise KeyError(f"the entry reports no {m['name']}")
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    log(f"memory peak {mem_peak} bytes; card {power_limit() if device.type == 'cuda' else '-'}")
    for k, v in facts.get("report", {}).items():
        log(f"{k}: {v}")

    entry.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = entry.check(state)
    log(f"check with the plain reference: {time.perf_counter() - t:.1f} s")
    for name, v, limit in checks:
        if limit is None:
            log(f"detail {name}: {v!r}")
    checks = [c for c in checks if c[2] is not None]
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    out = {"correct": correct, "attempted": facts["attempted"], "failed": facts["failed"],
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    for name, v, limit in checks:
        log(f"check {name} = {v!r} (limit {limit!r}) {'ok' if v <= limit else 'FAILS'}")
    # Last, after the metric readers and the reference have run in this process.
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in the measuring process: {bad}; no result")
        return None
    return out
