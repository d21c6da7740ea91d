"""Seconds from the start of the process to the window: the inputs made
from the seed, the program loaded (and, in a checkout's first run, its
kernels built), and one warm-up job."""


def read(run):
    return run.setup_s
