"""Contig bases evaluated a second: all the bases of all the window's jobs over
the time from the first job's start to the last one's end."""


def read(run):
    w = run.window
    return w.work / 1e6 / w.seconds if run.n_jobs and w.seconds > 0 else None
