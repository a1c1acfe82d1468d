"""k3_roofline: the least time K3 (the stack's training forward with saves)
could take for one step's batch (`counts.k3_flops`, `counts.k3_bytes`), over
the device time of K3's kernels a traced step, in %."""

from bench_port import counts

K3_KERNELS = ("prep_kernel", "gate_kernel", "out_kernel")


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_steps"):
        return None
    secs = tr.seconds_by_base()
    busy = sum(secs.get(k, 0.0) for k in K3_KERNELS) / r["traced_steps"]
    if busy <= 0:
        return None
    s, b = counts.shape_of(run.cfg), run.mix["batch"]
    return 100.0 * counts.bound_s(counts.k3_flops(s, b), counts.k3_bytes(s, b)) / busy
