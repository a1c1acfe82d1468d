"""transcribe.idle_ms_per_batch: milliseconds of the traced stretch's idle
card (gaps of 20 us or longer) whose innermost port span is one of
`transcribe_long`'s own stages, over the stretch's K2 batches."""

from bench_port import spans
from bench_port.runners.transcribe import batch_sizes

NAMES = ("transcribe.long", "transcribe.split", "transcribe.copy_in", "transcribe.draw",
         "transcribe.copy_out", "transcribe.stitch")


def read(run):
    r = run.records
    batches = sum(len(batch_sizes(n, run.mix["batch_size"]))
                  for n in r.get("traced_windows") or ())
    return spans.idle_ms_per_unit(r.get("trace"), NAMES, batches)
