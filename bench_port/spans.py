"""The card's idle time put down to the program's own spans.

The port names the stages of its host work with `torch.profiler` spans
(`user_annotation` events; `diffroll_tpu_torch/utils/profiling.py` declares
them). The yardstick keeps its own list of their names, `PORT_SPANS`, so
that it does not move with the program. A gap of `trace.SHORT_GAP_US` or
longer between device ops goes to the innermost port span, on any thread,
that holds the gap's midpoint; an aten op or a runtime call inside the span
does not take it from the span. A program without the spans leaves every
gap unattributed, and the metrics that read them report nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from bench_port import trace as bench_trace

PORT_SPANS = frozenset({
    "transcribe.long", "transcribe.split", "transcribe.copy_in", "transcribe.draw",
    "transcribe.copy_out", "transcribe.stitch",
    "sample", "sample.draw", "sample.k2", "conditioner",
    "train.step", "train.zero_grad", "train.loss", "train.backward", "train.allreduce",
    "train.optimizer", "train.data",
    "serve.request", "serve.gather", "serve.assemble", "serve.copy_in", "serve.issue",
    "serve.wait", "serve.copy_out", "serve.deliver",
})


def idle_ms_by_span(tr) -> Optional[Dict[str, float]]:
    """Milliseconds of the stretch's gaps of `SHORT_GAP_US` or longer, by the
    innermost port span holding each gap's midpoint; None if the trace holds
    no port span."""
    spans = [(s, e, n) for s, e, n in tr.host if n in PORT_SPANS]
    if not spans:
        return None
    out: Dict[str, float] = {}
    for g0, g1 in tr.gaps:
        if g1 - g0 < bench_trace.SHORT_GAP_US:
            continue
        mid = (g0 + g1) / 2
        best = None
        for start, end, name in spans:
            if start <= mid < end and (best is None or end - start < best[0]):
                best = (end - start, name)
        if best is not None:
            out[best[1]] = out.get(best[1], 0.0) + (g1 - g0) / 1e3
    return out


def idle_ms_per_unit(tr, names: Iterable[str], units: int) -> Optional[float]:
    """The milliseconds that land on `names`, over `units`; None where the
    trace holds no port span or there is no unit."""
    by_span = None if tr is None or not units else idle_ms_by_span(tr)
    if by_span is None:
        return None
    return sum(by_span.get(n, 0.0) for n in names) / units
