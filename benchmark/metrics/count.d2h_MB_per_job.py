"""Megabytes (1e6 B) a count job copies back to the host: the program's
counter spectrum.d2h_bytes (the histogram, the solid k-mers' two int64
halves and their int32 counts) over its counter spectrum.calls, both summed
over the whole process (the warm-up job and every window job, all of one
size).  None where the program has no such counters
(hga_tpu_torch.utils.spans)."""

COUNTER = "spectrum.d2h_bytes"


def read(run):
    try:
        from hga_tpu_torch.utils import spans
    except ImportError:        # a program without counters: nothing to read
        return None
    c = spans.counters("spectrum.")
    if not c["spectrum.calls"]:
        return None
    return c[COUNTER] / c["spectrum.calls"] / 1e6
