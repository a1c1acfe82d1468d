"""unet.attn_roofline: the least time of the bottleneck attention's forward
for one step's batch (`counts.spec_unet.attn_bound_s`: its two products at
the bf16 peak, q, k, v and the output once at HBM's rate), over the device
time inside the program's `unet.attn` spans a traced step, in %. Nothing
where the trace holds no such span."""

from bench_port.counts import spec_unet


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps") or not hasattr(tr, "device_s_in"):
        return None
    busy = tr.device_s_in("unet.attn") / r["traced_steps"]
    if busy <= 0:
        return None
    return 100.0 * spec_unet.attn_bound_s(spec_unet.shape_of(run.cfg), run.mix["batch"]) / busy
