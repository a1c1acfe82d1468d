"""train.model_idle_ms_per_step: milliseconds of the traced stretch's idle
card (gaps of 20 us or longer) whose innermost port span is the training
step itself, its zero_grad, its loss (the forward), its backward or the
conditioner, over the stretch's training steps."""

from bench_port import spans

NAMES = ("train.step", "train.zero_grad", "train.loss", "train.backward", "conditioner")


def read(run):
    r = run.records
    return spans.idle_ms_per_unit(r.get("trace"), NAMES, r.get("traced_steps"))
