"""A traced stretch that also keeps the card's side of the program's spans.

Under a profile that records the card, each `record_function` span that
launched work there has a `gpu_user_annotation` interval on the card's
clock, from its first device op to its last. `trace.Trace` drops them;
`Trace` here keeps them by name, clipped to the stretch, and gives the device
time inside a name's intervals. `breakdown`, `busy_s` and `window_s` are
`trace.Trace`'s. `stretch` is `trace.stretch` with this `Trace`.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import tempfile
from typing import Dict, List, Tuple

from bench_port import trace as bench_trace

GPU_ANNOTATION = "gpu_user_annotation"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


class Trace(bench_trace.Trace):
    """`trace.Trace` with the card's annotation intervals by name."""

    def __init__(self, events: List[dict]):
        super().__init__(events)
        self.annotations: Dict[str, List[Tuple[float, float]]] = {}
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == GPU_ANNOTATION
                    and e["ts"] + e["dur"] > self.t0 and e["ts"] < self.t1):
                self.annotations.setdefault(e["name"], []).append(
                    (max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)))

    def device_s_in(self, name: str) -> float:
        """Seconds of device ops inside the union of `name`'s intervals (0
        where the trace has none)."""
        spans = _union(self.annotations.get(name, []))
        total, j = 0.0, 0
        for start, end, _ in self.ops:   # sorted by start
            while j < len(spans) and spans[j][1] <= start:
                j += 1
            k = j
            while k < len(spans) and spans[k][0] < end:
                total += min(end, spans[k][1]) - max(start, spans[k][0])
                k += 1
        return total / 1e6


@contextlib.contextmanager
def stretch(out: dict):
    """Profile the wrapped block; afterwards `out["trace"]` holds its `Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(bench_trace.MARK):
            yield
            sync()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out["trace"] = Trace(events)
