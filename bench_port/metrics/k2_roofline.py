"""k2_roofline: the least time K2 could take for the reverse processes of the
traced stretch (`counts.k2_bound_s` a batch, the batches each traced
recording gives), over the device time of K2's kernels there, in %."""

from bench_port import counts
from bench_port.runners.transcribe import batch_sizes
from bench_port.reference.diffroll import guided

K2_KERNELS = ("proj_kernel", "head_in_kernel", "head_hidden_kernel", "head_out_kernel",
              "prep_kernel", "gate_kernel", "out_kernel")


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not r.get("traced_windows"):
        return None
    secs = tr.seconds_by_base()
    busy = sum(secs.get(k, 0.0) for k in K2_KERNELS)
    if busy <= 0:
        return None
    s = counts.shape_of(run.cfg)
    bound = sum(counts.k2_bound_s(s, b, run.cfg["timesteps"], guided(run.cfg))
                for n in r["traced_windows"] for b in batch_sizes(n, run.mix["batch_size"]))
    return 100.0 * bound / busy
