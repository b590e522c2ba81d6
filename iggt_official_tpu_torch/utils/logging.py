"""Training telemetry and profiling.

Counterpart of `iggt_official_tpu/utils/logging.py`: `SmoothedValue` and
`MetricLogger` (windowed medians and averages, the `log_every` iterator),
`AverageMeter`, `profile_trace` on `torch.profiler` (a Chrome trace per
call) and `span`, the port's one way to name a stretch of its own work in
such a trace: a `torch.profiler.record_function` range, opened only while a
profiler records, on the profiler's clock beside the device operations it
launches; it stands where the JAX package has `StageTimer`'s wall timers.
No metric is reduced across processes here: on a mesh the train step hands
the logger metrics already averaged over the ranks (`train/step.py`).
"""

from __future__ import annotations

import contextlib
import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

# True while a profiler records
_recording = torch._C._autograd._profiler_enabled
_NOTHING = contextlib.nullcontext()


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


def span(name: str):
    """A context manager naming what runs inside it ``name`` in a profiler's
    trace (a ``record_function`` range, the device operations launched
    inside it carrying it in their launch stacks); with no profiler
    recording, a shared no-op, so a span costs one check (an idle
    ``record_function`` costs a hundred times more)."""
    return record_function(name) if _recording() else _NOTHING


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Trace the host and, when there is one, the card with `torch.profiler`;
    yields the profiler.  With ``log_dir`` a Chrome trace is written there
    (a training step's trace holds ~10^5 events: writing it costs seconds)."""
    import os

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
