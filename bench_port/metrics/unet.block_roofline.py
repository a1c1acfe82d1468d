"""unet.block_roofline: the least time of every ConvNeXt block's forward for
one step's batch (`counts.spec_unet.blocks_bound_s`: its convolutions and
step projections at the bf16 peak, each block's inputs, outputs and weights
once at HBM's rate), over the device time inside the program's `unet.block`
spans a traced step, in %. Nothing where the trace holds no such span."""

from bench_port.counts import spec_unet


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps") or not hasattr(tr, "device_s_in"):
        return None
    busy = tr.device_s_in("unet.block") / r["traced_steps"]
    if busy <= 0:
        return None
    return 100.0 * spec_unet.blocks_bound_s(spec_unet.shape_of(run.cfg), run.mix["batch"]) / busy
