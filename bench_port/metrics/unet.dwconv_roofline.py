"""unet.dwconv_roofline: the least time of the forward's depthwise 7x7 convs
for one step's batch (`counts.unet_dwconvs.dwconvs_bound_s`: every call's
input read once and its output written once in f32 at HBM's rate), over the
device time inside the program's `unet.dwconv` spans a traced step, in %.
Nothing where the trace holds no such span."""

from bench_port.counts import spec_unet, unet_dwconvs


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps") or not hasattr(tr, "device_s_in"):
        return None
    busy = tr.device_s_in("unet.dwconv") / r["traced_steps"]
    if busy <= 0:
        return None
    return 100.0 * unet_dwconvs.dwconvs_bound_s(spec_unet.shape_of(run.cfg),
                                                run.mix["batch"]) / busy
