"""The per-layer metrics that read the program's own spans and counters
(hga_tpu_torch/utils/spans.py): each reader on a made-up run, and a traced
CPU run of the count cell, which reports the counter metrics and leaves the
gap metrics out (a CPU trace holds no device operation)."""

import copy
import os
import time
import types

import pytest

from benchmark import harness
from hga_tpu_torch.utils import spans

COUNT = "count.ecoli46-hybrid"
GAPS = {
    "count.prep_idle_ms_per_job": ("spectrum.batch_prep", "spectrum.h2d"),
    "count.out_idle_ms_per_job": ("spectrum.hist", "spectrum.solid_out"),
    "evalseg.prep_idle_ms_per_job": ("evalseg.encode_reference",
                                     "evalseg.cut", "evalseg.h2d"),
}
COUNTERS = {"count.h2d_MB_per_job": "spectrum.h2d_bytes",
            "count.d2h_MB_per_job": "spectrum.d2h_bytes"}


def _run(trace):
    return types.SimpleNamespace(trace=trace)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name", sorted(GAPS))
def test_gap_readers_sum_their_spans_gaps_a_job(name):
    gaps = {n: 0.001 * (i + 1) for i, n in enumerate(GAPS[name])}
    gaps.update({"(host code in the job, outside torch calls)": 5.0,
                 "spectrum.count_reads": 7.0, "aten::copy_": 3.0})
    trace = dict(jobs=4, n_ops=100, window_s=10.0, busy_s=9.0,
                 gaps_by_name=gaps)
    want = sum(0.001 * (i + 1) for i in range(len(GAPS[name]))) * 1e3 / 4
    assert _read(name, _run(trace)) == pytest.approx(want)
    # a span with no gap reads 0; no device operation or no trace: nothing
    assert _read(name, _run(dict(trace, gaps_by_name={}))) == 0.0
    assert _read(name, _run(dict(trace, n_ops=0))) is None
    assert _read(name, _run(None)) is None


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counter_readers_divide_by_the_calls(name):
    spans.reset("spectrum.")
    assert _read(name, _run(None)) is None            # no call counted
    spans.count("spectrum.calls", 3)
    spans.count(COUNTERS[name], 3 * 67_000_000)
    assert _read(name, _run(None)) == pytest.approx(67.0)
    spans.reset("spectrum.")


def test_traced_cpu_count_run_reports_the_counter_metrics():
    def small(c):
        c = copy.deepcopy(c)
        c["genome"]["length"] = 5_000
        c["batch_reads"] = 512
        return c

    spans.reset()
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    out, _ = harness.run_cell(bench, COUNT, 2**31 + 5, 0.0, True, "cpu",
                              time.perf_counter(), small)
    assert out["correct"]
    m = out["metrics"]
    for name in COUNTERS:
        assert m[name]["unit"] == "MB" and m[name]["value"] > 0, name
    for name in GAPS:
        assert name not in m, name
    c = spans.counters("spectrum.")
    assert c["spectrum.calls"] == out["attempted"] + 1      # with warm-up
    spans.reset()
