"""unet.spec_stream_ms_per_batch: milliseconds of device ops inside the
program's `unet.spec_stream` spans' card intervals (`trace_annotated.py`),
over the traced stretch's batches. Nothing where the trace holds no such
span."""

from bench_port.runners.transcribe import batch_sizes


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_windows") or not hasattr(tr, "device_s_in"):
        return None
    busy = tr.device_s_in("unet.spec_stream")
    if busy <= 0:
        return None
    batches = sum(len(batch_sizes(n, run.mix["batch_size"])) for n in r["traced_windows"])
    return 1e3 * busy / batches
