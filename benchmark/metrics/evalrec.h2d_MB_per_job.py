"""Megabytes (1e6 B) an evaluation job copies to the card: the program's
counter evalseg.h2d_bytes (the row, and each batch's segment codes and
lengths, as shipped) over its counter evalseg.calls, both summed over the
whole process (the warm-up job and every window job, all of one size).
None where the program has no such counters (hga_tpu_torch.utils.spans)."""

COUNTER = "evalseg.h2d_bytes"


def read(run):
    try:
        from hga_tpu_torch.utils import spans
    except ImportError:        # a program without counters: nothing to read
        return None
    c = spans.counters("evalseg.")
    if not c["evalseg.calls"]:
        return None
    return c[COUNTER] / c["evalseg.calls"] / 1e6
