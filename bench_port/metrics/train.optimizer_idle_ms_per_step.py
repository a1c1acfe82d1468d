"""train.optimizer_idle_ms_per_step: milliseconds of the traced stretch's
idle card (gaps of 20 us or longer) whose innermost port span is the
optimizer's step, over the stretch's training steps."""

from bench_port import spans

NAMES = ("train.optimizer",)


def read(run):
    r = run.records
    return spans.idle_ms_per_unit(r.get("trace"), NAMES, r.get("traced_steps"))
