"""Reduce a `torch.profiler` trace of the traced window to what the metrics read.

The profiler's Chrome trace is written under ``TMPDIR``, read back and
deleted.  Every device operation (kernel, memcpy, memset) is tied through its
correlation id to the runtime call that launched it, and so to the stack of
CPU ops that were open on the launching thread at that moment
(``chip_smoke.py::profile_buckets`` buckets by the same link).  Only device
operations inside the window's ``record_function`` span are kept, clipped to
it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceOp(NamedTuple):
    name: str
    start: float          # seconds on the trace clock
    end: float
    stack: Tuple[str, ...]  # CPU ops open at the launch, outermost first


class Trace(NamedTuple):
    ops: List[DeviceOp]
    window: Tuple[float, float]
    busy: List[Tuple[float, float]]     # merged busy intervals inside the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def time_of(self, predicate) -> float:
        """Device seconds of the ops whose (name, stack) satisfy ``predicate``."""
        return sum(o.end - o.start for o in self.ops if predicate(o.name, o.stack))


def from_profiler(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events)


def from_events(events) -> Trace:
    window: Optional[Tuple[float, float]] = None
    cpu_by_tid: Dict[object, list] = defaultdict(list)
    launches: Dict[object, list] = defaultdict(list)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in ("cpu_op", "user_annotation"):
            if e.get("name") == WINDOW_SPAN and cat == "user_annotation":
                window = (ts, ts + dur)
            cpu_by_tid[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[e.get("tid")].append((ts, corr))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), e.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")

    stack_of: Dict[object, Tuple[str, ...]] = {}
    for tid, calls in launches.items():
        ops = sorted(cpu_by_tid.get(tid, []), key=lambda o: (o[0], -o[1]))
        calls.sort()
        open_ops: List[Tuple[float, float, str]] = []
        i = 0
        for ts, corr in calls:
            while i < len(ops) and ops[i][0] <= ts:
                while open_ops and open_ops[-1][1] < ops[i][0]:
                    open_ops.pop()
                open_ops.append(ops[i])
                i += 1
            while open_ops and open_ops[-1][1] < ts:
                open_ops.pop()
            stack_of[corr] = tuple(o[2] for o in open_ops if o[1] >= ts)

    w0, w1 = window
    kept = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kept.append(DeviceOp(name, s * 1e-6, e * 1e-6, stack_of.get(corr, ())))
    kept.sort(key=lambda o: o.start)
    busy: List[Tuple[float, float]] = []
    for o in kept:
        if busy and o.start <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], o.end))
        else:
            busy.append((o.start, o.end))
    return Trace(kept, (w0 * 1e-6, w1 * 1e-6), busy)


def _label(stack: Tuple[str, ...]) -> str:
    inner = [s for s in stack if s != WINDOW_SPAN]
    return " > ".join(inner[-2:]) if inner else "(no CPU op open)"


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device ops that took most time (by name), and the idle time of the
    window by what the host was doing: each gap is named after the CPU ops
    that launched the operation ending it (the window's tail after the last
    operation: "after the last device op")."""
    by_name: Dict[str, float] = defaultdict(float)
    for o in tr.ops:
        by_name[o.name[:160]] += o.end - o.start
    gaps: Dict[str, float] = defaultdict(float)
    starts = [o.start for o in tr.ops]
    prev_end = tr.window[0]
    for s, e in tr.busy:
        if s > prev_end:
            nxt = tr.ops[bisect.bisect_left(starts, s)]
            gaps[_label(nxt.stack)] += s - prev_end
        prev_end = e
    if tr.window[1] > prev_end:
        gaps["after the last device op"] += tr.window[1] - prev_end
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_name), "idle_gaps": order(gaps)}
