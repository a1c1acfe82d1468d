"""Device busy and idle time, and operations by name, from a `torch.profiler`
trace of a bounded stretch of the window.

`stretch()` profiles the host and the card over the block it wraps, marks
the block with the annotation `bench.stretch`, synchronises at both ends,
exports the chrome trace into the run's temporary directory, reads it and
deletes it. `Trace` reads it as the port's `profile_sampler.device_timeline`
and `device_ops` do (the union of the device ops' intervals is the busy
time, the stretches between them the gaps; time summed by op name), clipped
to the marked stretch; the copy sits here so that the yardstick does not
move with the program.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "bench.stretch"
SHORT_GAP_US = 20.0   # gaps shorter than this are summed together, not attributed
SHORT_GAP = f"gaps under {SHORT_GAP_US:g} us between device ops"


def kernel_base(name: str) -> str:
    """A device op's base name: `void gate_kernel<true>(...)` -> `gate_kernel`."""
    name = re.sub(r"^(void|static|__global__)\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


class Trace:
    """What a traced stretch recorded, clipped to the stretch."""

    def __init__(self, events: List[dict]):
        marks = [e for e in events if e.get("ph") == "X" and e.get("name") == MARK
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace holds no {MARK} annotation")
        mark = marks[0]
        self.t0, self.t1 = mark["ts"], mark["ts"] + mark["dur"]
        self.window_s = mark["dur"] / 1e6
        self.ops = sorted(
            (max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and e["ts"] + e["dur"] > self.t0 and e["ts"] < self.t1)
        self.host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                     and e.get("name") != MARK]
        self.gaps = self._gaps()
        self.busy_s = self.window_s - sum(g1 - g0 for g0, g1 in self.gaps) / 1e6

    def _gaps(self) -> List[Tuple[float, float]]:
        out, busy_until = [], self.t0
        for start, end, _ in self.ops:
            if start > busy_until:
                out.append((busy_until, start))
            busy_until = max(busy_until, end)
        if self.t1 > busy_until:
            out.append((busy_until, self.t1))
        return out

    def seconds_by_base(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for start, end, name in self.ops:
            key = kernel_base(name)
            out[key] = out.get(key, 0.0) + (end - start) / 1e6
        return out

    def host_at(self, ts: float) -> str:
        """The innermost host event running at `ts`."""
        best: Optional[Tuple[float, str]] = None
        for start, end, name in self.host:
            if start <= ts < end and (best is None or end - start < best[0]):
                best = (end - start, name)
        return "no host event" if best is None else best[1]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time summed by
        what the host was doing in the middle of each gap."""
        ops: Dict[str, float] = {}
        for start, end, name in self.ops:
            ops[name[:80]] = ops.get(name[:80], 0.0) + (end - start) / 1e6
        idle: Dict[str, float] = {}
        for g0, g1 in self.gaps:
            key = (SHORT_GAP if g1 - g0 < SHORT_GAP_US
                   else self.host_at((g0 + g1) / 2)[:80])
            idle[key] = idle.get(key, 0.0) + (g1 - g0) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def annotate(name: str):
    """A span of the benchmark's own around a call into the program; a traced
    stretch names the host's work in an idle gap by the innermost one."""
    from torch.profiler import record_function

    return record_function(name)


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
        with record_function(MARK):
            yield
            sync()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    out["trace"] = Trace(events)
