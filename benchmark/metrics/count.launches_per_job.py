"""Device operations (kernels, copies, sets) a count job puts on the card:
what count_reads' host batch loop issues, over the traced window's jobs."""


def read(run):
    t = run.trace
    if not t or not t["jobs"] or not t["n_ops"]:
        return None
    return t["n_ops"] / t["jobs"]
