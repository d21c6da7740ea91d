"""Device milliseconds a count job: the summed time of every kernel, copy
and set the traced window put on the card (ops.kmer extraction and
ops.count's sort and segment sum), over its jobs."""


def read(run):
    t = run.trace
    if not t or not t["jobs"] or not t["n_ops"]:
        return None
    return t["device_s"] * 1e3 / t["jobs"]
