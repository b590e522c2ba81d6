"""Training telemetry and profiling.

Counterpart of `iggt_official_tpu/utils/logging.py`: `SmoothedValue` and
`MetricLogger` (windowed medians and averages, the `log_every` iterator),
`AverageMeter`, `StageTimer` (per-stage wall timers that synchronize the
card before they read the clock, so queued kernels are counted) and
`profile_trace` on `torch.profiler` (a Chrome trace per call).  The port
trains on one card, so no metric is reduced across processes.
"""

from __future__ import annotations

import contextlib
import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


class SmoothedValue:
    """Windowed value tracker (`misc.py:30-80`)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Named SmoothedValues + periodic logging (`misc.py:83-178`)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        i = 0
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    head = f"{header} [{i}/{total}] eta: {eta_str}"
                else:
                    head = f"{header} [{i}]"
                self.print_fn(
                    f"{head}  {self}  time: {iter_time}  data: {data_time}"
                )
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(elapsed))} "
            f"({elapsed / max(i, 1):.4f} s / it)"
        )


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Trace the host and, when there is one, the card with `torch.profiler`;
    yields the profiler.  With ``log_dir`` a Chrome trace is written there
    (a training step's trace holds ~10^5 events: writing it costs seconds)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Per-stage wall timers that respect asynchronous launches.

    Usage:
        timer = StageTimer()
        with timer.stage("forward") as holder:
            out = step(...)
            holder["sync_on"] = out

    With ``sync_on`` set, the card is synchronized (its tensors' devices)
    before the clock is read."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "sync_on" in holder:
                _synchronize(holder["sync_on"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            name: self.totals[name] / max(self.counts[name], 1)
            for name in self.totals
        }


def _synchronize(tree) -> None:
    """Wait for the card(s) that hold any tensor in ``tree``."""
    import torch

    stack, devices = [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class AverageMeter:
    """Running (optionally exponentially decayed) average
    (`utils/misc.py:44-64` semantics)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: int = 1, decay: float = 0.0):
        import math

        self.val = val
        if decay:
            alpha = math.exp(-n / decay)
            self.sum = alpha * self.sum + (1 - alpha) * val * n
            self.count = alpha * self.count + (1 - alpha) * n
        else:
            self.sum += val * n
            self.count += n
        self.avg = self.sum / self.count
