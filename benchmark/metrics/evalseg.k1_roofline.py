"""K1''s shared-target sweep against its roofline: the least time the card
could take for the traced jobs (roofline.myers_bound_s from each job's
shapes: segments x reference columns x ceil(seg / 32) words x 20 int32
operations, over the frozen int32 peak), over the device time of all the
jobs' operations, whatever their names, in percent."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t or not t["jobs"] or not t["n_ops"] or t["device_s"] <= 0:
        return None
    bound = 0.0
    for i in run.window.inputs[:t["jobs"]]:      # the traced jobs
        s = run.jobs.shapes(i)
        b = roofline.myers_bound_s(s["segments"], s["target_cols"], s["seg"],
                                   run.device_kind)
        if b is None:
            return None
        bound += b
    return 100.0 * bound / t["device_s"]
