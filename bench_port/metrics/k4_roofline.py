"""k4_roofline: the least time K4 (the stack's backward) could take for one
step's batch (`counts.k4_flops`, `counts.k4_bytes`; no conditioner gradient,
as the mel front end has no parameters), over the device time of K4's
kernels a traced step, in %."""

from bench_port import counts

K4_KERNELS = ("dout_init_kernel", "y_kernel", "nt_kernel", "wgrad_kernel", "reduce_kernel",
              "seqsum_kernel")


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps"):
        return None
    secs = tr.seconds_by_base()
    busy = sum(secs.get(k, 0.0) for k in K4_KERNELS) / r["traced_steps"]
    if busy <= 0:
        return None
    s, b = counts.shape_of(run.cfg), run.mix["batch"]
    return 100.0 * counts.bound_s(counts.k4_flops(s, b), counts.k4_bytes(s, b)) / busy
