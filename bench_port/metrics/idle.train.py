"""idle.train: the share of the traced stretch of training steps in which no
operation ran on the card, in %."""


def read(run):
    tr = run.records.get("trace")
    if tr is None or not tr.ops or "steps" not in run.records or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
