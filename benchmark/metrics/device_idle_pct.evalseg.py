"""The share of the traced window (first job's start to last job's end) in
which no operation ran on the card."""


def read(run):
    t = run.trace
    if not t or not t["jobs"] or not t["n_ops"] or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
