"""Profiling helpers (counterpart of `diffroll_tpu/utils/profiling.py`):
`trace_if` wraps a window of training steps in a `torch.profiler` trace
(a chrome trace under `log_dir`); `StepTimer` keeps a cheap host-side
steps/sec + examples/sec counter for the metrics stream."""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Optional


@contextlib.contextmanager
def trace_if(enabled: bool, log_dir: str):
    """Profile the enclosed block with torch.profiler when enabled."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(pathlib.Path(log_dir) / "trace.json"))


class StepTimer:
    """Rolling steps/sec + examples/sec between `tick()` calls."""

    def __init__(self):
        self._t: Optional[float] = None
        self._steps = 0
        self._examples = 0

    def tick(self, batch_size: int):
        if self._t is None:
            self._t = time.perf_counter()
        self._steps += 1
        self._examples += batch_size

    def rates(self) -> dict:
        if self._t is None or self._steps == 0:
            return {}
        dt = time.perf_counter() - self._t
        if dt <= 0:
            return {}
        out = {
            "perf/steps_per_sec": self._steps / dt,
            "perf/examples_per_sec": self._examples / dt,
        }
        self._t = time.perf_counter()
        self._steps = 0
        self._examples = 0
        return out
