"""Idle milliseconds an evaluation job under segment_identity's host
preparation: the card's idle gaps in the traced window whose innermost host
event is the span evalseg.encode_reference (the two-strand row encoded),
evalseg.cut (the contig cut into segments in Python) or evalseg.h2d (the
row's and each batch's padding and copies to the card), over the traced
jobs.  A gap "under" a span is one where that span itself is innermost,
i.e. Python or NumPy code in it; a gap under a torch call inside the span
keeps that call's name.  None where the program has no spans
(hga_tpu_torch.utils.spans) or the trace no device operations."""

SPANS = ("evalseg.encode_reference", "evalseg.cut", "evalseg.h2d")


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
