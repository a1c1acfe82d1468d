"""windows_per_s: windows of 640 frames whose rolls reached the host, over all
the time of the window (host clock; the window ends with the recording in
flight at its deadline)."""


def read(run):
    r = run.records
    if "recordings" not in r or r["elapsed_s"] <= 0:
        return None
    return r["windows"] / r["elapsed_s"]
