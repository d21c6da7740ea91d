"""The port's spans and counters (hga_tpu_torch/utils/spans.py): a span costs
two clock reads with no profiler on, lands in a torch.profiler trace nested
in its parent while one records, a kernel launch is a span and a counter of
one name, and the counters of count_reads equal the bytes it ships."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import pack_reads
from hga_tpu_torch.models.spectrum import count_reads
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.evalx import segment_identity

COUNT_SPANS = ("spectrum.batch_prep", "spectrum.h2d", "spectrum.extract",
               "spectrum.count", "spectrum.hist", "spectrum.solid_out")
EVALSEG_SPANS = ("evalseg.encode_reference", "evalseg.cut", "evalseg.h2d",
                 "evalseg.sweep", "evalseg.reduce")


def _reads(n=50, seed=4):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        L = int(rng.integers(30, 64))
        seqs.append("".join("ACGT"[c] for c in rng.integers(0, 4, L)))
    return pack_reads(seqs, pad_len=64)


def _assembly(seed=5, glen=1500):
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, glen))
    contig = genome[200:1100]
    contig = contig[:300] + "A" + contig[301:]           # one substitution
    return [("c1", contig)], genome


def _trace(fn, tmp_path):
    """Run fn under a CPU profiler; its user annotations, {name: [(start,
    end)]} on the trace's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            a = float(e["ts"])
            out.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out


def _nested(spans_seen, inner, outer):
    (a, b), = spans_seen[outer]
    return all(a <= x and y <= b for x, y in spans_seen[inner])


def test_span_without_a_profiler_reads_the_clock_only(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    with spans.span("test.sleep") as sp:
        time.sleep(0.02)
    assert 0.02 <= sp.seconds < 1.0
    with spans.span("test.empty") as sp:
        pass
    assert 0.0 <= sp.seconds < 0.01


def test_span_under_a_profiler_is_a_nested_user_annotation(tmp_path):
    def work():
        with spans.span("test.outer"):
            with spans.span("test.inner") as sp:
                torch.ones(4).sum()
        assert sp.seconds > 0

    seen = _trace(work, tmp_path)
    assert len(seen["test.outer"]) == 1 and len(seen["test.inner"]) == 1
    assert _nested(seen, "test.inner", "test.outer")


def test_count_reads_spans_in_the_trace(tmp_path):
    pr = _reads()
    cfg = AssemblerConfig(k=15, batch_reads=16)
    seen = _trace(lambda: count_reads(pr, cfg, device="cpu"), tmp_path)
    assert len(seen["spectrum.count_reads"]) == 1
    for name in COUNT_SPANS:
        assert name in seen, name
        assert _nested(seen, name, "spectrum.count_reads"), name
    for name in ("spectrum.h2d", "spectrum.extract"):
        assert len(seen[name]) == 4, name          # 50 reads, 16 a batch
    assert len(seen["spectrum.batch_prep"]) == 5   # and the rows to count


def test_segment_identity_spans_in_the_trace(tmp_path):
    contigs, genome = _assembly()
    seen = _trace(lambda: segment_identity(contigs, genome, seg=128,
                                           batch=4, device="cpu"), tmp_path)
    assert len(seen["evalseg.segment_identity"]) == 1
    for name in EVALSEG_SPANS:
        assert name in seen, name
        assert _nested(seen, name, "evalseg.segment_identity"), name
    # 8 segments in batches of 4: the row's copy and two batches'
    assert len(seen["evalseg.sweep"]) == len(seen["evalseg.reduce"]) == 2
    assert len(seen["evalseg.h2d"]) == 3


def test_count_reads_counts_the_bytes_it_ships():
    pr = _reads()
    cfg = AssemblerConfig(k=15, batch_reads=16)
    spans.reset("spectrum.")
    res = count_reads(pr, cfg, device="cpu")
    got = spans.counters("spectrum.")
    assert got["spectrum.calls"] == 1
    assert got["spectrum.h2d_bytes"] == (pr.packed.nbytes + pr.bad.nbytes
                                         + pr.length.nbytes)
    # hi and lo travel as int64, the counts as int32, the histogram int32
    assert got["spectrum.d2h_bytes"] == (16 * res.hi.size + res.count.nbytes
                                         + res.hist.nbytes)
    count_reads(pr, cfg, device="cpu")
    again = spans.counters("spectrum.")
    assert again == {k: 2 * v for k, v in got.items()}


def test_launch_is_a_span_and_a_counter_of_one_name(tmp_path):
    """spans.launch(route): the span launch.<route>, and the counter of that
    name moved by .n once the block has run, not where it raised."""
    def work():
        with spans.launch("test_route"):
            torch.ones(4).sum()
        with spans.launch("test_route") as sp:
            sp.n = 3                        # a block of three launches
        with pytest.raises(RuntimeError):
            with spans.launch("test_failed"):
                raise RuntimeError("launch failed")

    before = spans.launches()
    seen = _trace(work, tmp_path)
    assert len(seen["launch.test_route"]) == 2
    assert len(seen["launch.test_failed"]) == 1
    assert spans.launches() - before == {"test_route": 4}
    assert spans.counters("launch.test_") == {"launch.test_route": 4}
    assert spans.launches()["test_failed"] == 0
    spans.reset("launch.test_")


def test_reset_clears_only_its_prefix():
    spans.reset("t1.")
    spans.reset("t2.")
    spans.count("t1.a", 3)
    spans.count("t1.b")
    spans.count("t2.a", 5)
    assert spans.counters("t1.") == {"t1.a": 3, "t1.b": 1}
    spans.reset("t1.")
    assert spans.counters("t1.") == {}
    assert spans.counters("t1.")["t1.a"] == 0       # never counted reads 0
    assert spans.counters("t2.") == {"t2.a": 5}
    spans.reset("t2.")
