"""unet.norm_roofline: the least time of the forward's GroupNorms for one
step's batch (`counts.unet_norms.norms_bound_s`: every call's input read once
and its output written once in f32 at HBM's rate), over the device time
inside the program's `unet.norm` spans a traced step, in %. Nothing where the
trace holds no such span."""

from bench_port.counts import spec_unet, unet_norms


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps") or not hasattr(tr, "device_s_in"):
        return None
    busy = tr.device_s_in("unet.norm") / r["traced_steps"]
    if busy <= 0:
        return None
    return 100.0 * unet_norms.norms_bound_s(spec_unet.shape_of(run.cfg), run.mix["batch"]) / busy
