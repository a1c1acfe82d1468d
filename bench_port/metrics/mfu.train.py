"""mfu.train: the forward and backward model operations of the traced steps
(`counts.train_window_flops` a window, three times the forward, nothing
counted twice for recomputation), over the stretch's time and the card's
bf16 peak, in %."""

from bench_port import counts


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not tr.ops or not r.get("traced_steps") or tr.window_s <= 0:
        return None
    flops = r["traced_steps"] * run.mix["batch"] * counts.train_window_flops(
        counts.shape_of(run.cfg))
    return 100.0 * flops / (tr.window_s * counts.PEAK_BF16_FLOPS)
