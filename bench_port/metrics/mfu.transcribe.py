"""mfu.transcribe: the model operations of the windows transcribed in the
traced stretch (`counts.window_flops`), over the stretch's time and the
card's bf16 peak, in %."""

from bench_port import counts
from bench_port.reference.diffroll import guided


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not tr.ops or not r.get("traced_windows") or tr.window_s <= 0:
        return None
    flops = sum(r["traced_windows"]) * counts.window_flops(
        counts.shape_of(run.cfg), run.cfg["timesteps"], guided(run.cfg))
    return 100.0 * flops / (tr.window_s * counts.PEAK_BF16_FLOPS)
