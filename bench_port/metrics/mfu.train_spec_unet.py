"""mfu.train_spec_unet: the forward and backward model operations of the
traced steps (`counts.spec_unet.train_window_flops` a window, three times the
forward, as `mfu.train` counts the stack's), over the stretch's time and the
card's bf16 peak, in %."""

from bench_port import counts
from bench_port.counts import spec_unet


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not tr.ops or not r.get("traced_steps") or tr.window_s <= 0:
        return None
    flops = r["traced_steps"] * run.mix["batch"] * spec_unet.train_window_flops(
        spec_unet.shape_of(run.cfg))
    return 100.0 * flops / (tr.window_s * counts.PEAK_BF16_FLOPS)
