"""train_windows_per_s: training windows in completed optimizer steps, over
all the time of the window, which ends on a synchronize (host clock)."""


def read(run):
    r = run.records
    if "steps" not in r or r["elapsed_s"] <= 0:
        return None
    return r["windows"] / r["elapsed_s"]
