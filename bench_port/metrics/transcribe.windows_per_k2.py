"""transcribe.windows_per_k2: windows transcribed over reverse processes
launched on the card (`fused_sample.launches`, the port's counter), over the
whole window: how full `transcribe_long` keeps K2's batches."""


def read(run):
    r = run.records
    if not r.get("k2_launches"):
        return None
    return r["windows"] / r["k2_launches"]
