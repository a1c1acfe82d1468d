"""mfu.transcribe_spec_unet: the model operations that the windows of the
traced stretch need under guided sampling (`counts.spec_unet_sample
.window_flops`: the x stream every step and the spectrogram stream once, each
on both guidance branches), over the stretch's time and the card's bf16
peak, in %. A route that runs the whole forward every step reads lower."""

from bench_port import counts
from bench_port.counts import spec_unet, spec_unet_sample


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not tr.ops or not r.get("traced_windows") or tr.window_s <= 0:
        return None
    flops = sum(r["traced_windows"]) * spec_unet_sample.window_flops(
        spec_unet.shape_of(run.cfg), run.cfg["timesteps"])
    return 100.0 * flops / (tr.window_s * counts.PEAK_BF16_FLOPS)
