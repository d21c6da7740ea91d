"""Idle milliseconds a count job under count_reads' results coming back to
the host: the card's idle gaps in the traced window whose innermost host
event is the span spectrum.hist (the histogram's copy back and the valley
threshold) or spectrum.solid_out (the solid set's mask, copies back and
conversions), over the traced jobs.  A gap "under" a span is one where that
span itself is innermost, i.e. Python or NumPy code in it; a gap under a
torch call inside the span keeps that call's name.  None where the program
has no spans (hga_tpu_torch.utils.spans) or the trace no device
operations."""

SPANS = ("spectrum.hist", "spectrum.solid_out")


def read(run):
    try:
        from hga_tpu_torch.utils import spans  # noqa: F401
    except ImportError:        # a program without spans: nothing to read
        return None
    t = run.trace
    if not t or not t["jobs"] or not t["n_ops"]:
        return None
    gaps = t.get("gaps_by_name", {})
    return sum(gaps.get(n, 0.0) for n in SPANS) * 1e3 / t["jobs"]
