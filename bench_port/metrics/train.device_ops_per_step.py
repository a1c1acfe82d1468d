"""train.device_ops_per_step: operations run on the card (kernels, copies,
sets) in the traced stretch, over its training steps."""


def read(run):
    r = run.records
    tr = r.get("trace")
    if tr is None or not tr.ops or not r.get("traced_steps"):
        return None
    return len(tr.ops) / r["traced_steps"]
