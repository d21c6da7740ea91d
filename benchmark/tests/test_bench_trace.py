"""The trace's reduction on a hand-made Chrome trace: the window, the busy
union, the operations by name and the idle gaps by host event."""

import json

import pytest

from benchmark import devtrace


def ev(cat, name, ts, dur, tid=1):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid)


def test_summarize(tmp_path):
    events = [
        ev("user_annotation", "bench.job", 100, 100),
        ev("user_annotation", "bench.job", 210, 90),
        ev("cpu_op", "aten::sort", 120, 30),
        ev("cuda_runtime", "cudaMemcpyAsync", 125, 10),
        ev("cpu_op", "aten::add", 230, 10),
        ev("cpu_op", "aten::mul", 150, 5, tid=2),      # another thread
        ev("kernel", "k_a", 90, 30, tid=7),           # clipped to 100-120
        ev("kernel", "k_a", 140, 20, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH", 150, 20, tid=7),   # overlaps k_a
        ev("kernel", "k_b", 250, 45, tid=7),
        ev("kernel", "k_b", 400, 40, tid=7),          # outside the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    s = devtrace.summarize(str(path), "bench.job")
    assert s["jobs"] == 2 and s["n_ops"] == 4
    assert s["window_s"] == pytest.approx(200e-6)
    # busy: 100-120, 140-170, 250-295 = 95 us; summed ops 20+20+20+45
    assert s["busy_s"] == pytest.approx(95e-6)
    assert s["device_s"] == pytest.approx(105e-6)
    assert s["ops_by_name"]["k_b"] == pytest.approx(45e-6)
    g = s["gaps_by_name"]
    # gaps 120-140 (mid 130: the memcpy call), 170-250 (mid 210: the second
    # job's annotation), 295-300 (mid 297.5: the job)
    assert g["cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert g["(host code in the job, outside torch calls)"] == pytest.approx(
        85e-6)
    b = devtrace.breakdown(s)
    assert b["device_ops"][0][0] == "k_b" and len(b["idle_gaps"]) == 2


def test_no_job_no_numbers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps([ev("kernel", "k", 0, 5)]))
    assert devtrace.summarize(str(path), "bench.job") == dict(jobs=0)


def test_a_traced_run_profiles_the_first_seconds(monkeypatch):
    """Past TRACE_SECONDS the window runs on untraced, and every job is
    still checked."""
    import copy
    import os
    import time

    from benchmark import harness

    def small(c):
        c = copy.deepcopy(c)
        c["genome"]["length"] = 5_000
        c["batch_reads"] = 512
        return c

    seen, orig = [], devtrace.summarize

    def summarize(path, job_name):
        s = orig(path, job_name)
        seen.append(s["jobs"])
        return s

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    monkeypatch.setattr(devtrace, "summarize", summarize)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    out, _ = harness.run_cell(bench, "count.ecoli46-hybrid", 3, 10.0, True,
                              "cpu", time.perf_counter(), small)
    assert out["correct"] and out["attempted"] >= 2
    assert seen == [1]                              # one job traced
    assert list(out)[-2:] == ["breakdown", "checks"]
