"""``hga-torch bench`` against ``hga bench`` (hga_tpu.utils.benchmarks): the
same modes, JSON keys and cell counts, a roofline computed from the H100's
constants (not the TPU's 200 GCUPS), both correction engines, and the
distribution modes `scaling` and `comm` (on one rank here; two ranks in
test_torch_distributed_pipeline.py).
Run on the CPU at a few pairs; times and rates here are the CPU's."""

import json

import numpy as np
import pytest
import torch

from hga_tpu.ops.align import sw_cells as jax_sw_cells
from hga_tpu.utils import benchmarks as JB
from hga_tpu_torch.cli import main as tmain
from hga_tpu_torch.utils import benchmarks as TB
from hga_tpu_torch.utils import spans

# the JAX modes' keys (hga_tpu/utils/benchmarks.py bench_pipeline, :276)
PIPELINE_KEYS = {"reads", "seconds", "reads_per_s", "contigs"}
# bench_scaling's keys (:320-342): one device's, and those a mesh adds
SCALING_KEYS = {"devices", "reads", "single_reads_per_s"}
SCALING_MESH_KEYS = {"sharded_reads_per_s", "scaling_efficiency"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(capsys, *args):
    assert tmain(["bench", *args, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("what", ["sw", "myers"])
def test_dp_modes_have_the_jax_keys_and_cells(what, capsys):
    n = 8
    ref = (JB.bench_sw if what == "sw" else JB.bench_myers)(n_pairs=n)
    got = _bench(capsys, "--what", what, "--pairs", str(n))
    assert set(ref) <= set(got), set(ref) - set(got)
    for k in ("n_pairs", "Lq", "Lt", "band", "cells"):
        if k in ref:
            assert got[k] == ref[k], k
    if what == "sw":
        assert got["cells"] == jax_sw_cells([128], [256], 64) * n
    else:
        assert got["cells"] == n * 128 * 192
    assert got["impl"] == "plain" and got["device"] == "cpu"
    assert got["gcups"] > 0 and got["seconds"] > 0
    assert got["roofline_gcups"] != JB.ROOFLINE_GCUPS
    assert got["baseline_gcups"] == pytest.approx(0.7 * got["roofline_gcups"])


def test_roofline_comes_from_the_h100_constants():
    # banded SW: 12 int32 operations a cell at 132 x 64 x 1.98e9 a second
    sw = TB.bench_sw(n_pairs=4, device="cpu")
    assert sw["bound_by"] == "operations"
    assert sw["roofline_gcups"] == pytest.approx(
        TB.INT32_OPS_PER_S / TB.SW_OPS_PER_CELL / 1e9)
    # Myers: 20 operations a word and column; Lq 128 is 5 words
    my = TB.bench_myers(n_pairs=4, device="cpu")
    assert my["roofline_gcups"] == pytest.approx(
        128 * TB.INT32_OPS_PER_S / (5 * TB.OPS_PER_WORD_COLUMN) / 1e9)
    assert TB.bound_ms(0, TB.HBM_BYTES_PER_S) == (1e3, "bytes")


def test_count_and_pipeline_modes_have_the_jax_keys(capsys):
    ref = JB.bench_count(n_reads=64)
    got = TB.bench_count(n_reads=64, device="cpu")
    assert set(ref) <= set(got), set(ref) - set(got)
    assert got["reads_per_s"] > 0
    got = _bench(capsys, "--what", "count")
    assert set(ref) <= set(got) and got["device"] == "cpu"
    got = _bench(capsys, "--what", "pipeline")
    assert PIPELINE_KEYS <= set(got), PIPELINE_KEYS - set(got)
    assert got["reads"] > 500 and got["contigs"] >= 1


def test_bench_on_cpu_launches_no_kernel(capsys):
    before = spans.launches()
    _bench(capsys, "--what", "myers", "--pairs", "4")
    _bench(capsys, "--what", "sw", "--pairs", "4")
    assert spans.launches() == before


@pytest.mark.parametrize("what", ["scaling", "comm"])
def test_unported_modes_raise(what, capsys):
    """The distribution modes no longer raise: `comm` prints the
    reference's model dict exactly, `scaling` on one rank the reference's
    keys of a one-device run (no sharded rate without a second rank)."""
    if what == "comm":
        got = _bench(capsys, "--what", "comm")
        assert got == json.loads(json.dumps(JB.comm_volume_model()))
        return
    got = TB.bench_scaling(n_reads=64, device="cpu")
    assert set(got) == SCALING_KEYS | {"device"}
    assert got["devices"] == 1 and got["reads"] == 64
    assert got["single_reads_per_s"] > 0


def test_correction_mode_has_the_jax_keys(capsys):
    """`bench --what correction`: both engines with the keys and cell
    count of hga_tpu/utils/benchmarks.py bench_correction, CPU times."""
    got = _bench(capsys, "--what", "correction", "--pairs", "8")
    assert set(got) == {"myers", "sw"}
    for eng, r in got.items():
        assert {"engine", "seconds", "aln_per_s", "gcups", "n_pairs", "Lq",
                "Wt"} <= set(r)
        assert r["engine"] == eng and r["impl"] == "plain"
        assert (r["n_pairs"], r["Lq"], r["Wt"]) == (8, 112, 112 + 64 + 8)
        assert r["device"] == "cpu" and r["seconds"] > 0
        assert r["gcups"] == pytest.approx(8 * 112 * 184 / r["seconds"]
                                           / 1e9)


def test_cpu_timer_measures_calls():
    calls = []
    ms = TB.time_ms(lambda x: calls.append(x), [(1,), (2,)], 3,
                    torch.device("cpu"), passes=2)
    assert ms >= 0
    # one warm-up call per input set, then reps calls a pass, cycling
    assert calls == [1, 2, 1, 2, 1, 1, 2, 1]
    assert np.isfinite(ms)


def _root_bench_keys(monkeypatch, capsys):
    """The keys of the repo root's bench.py line, in its order, its JAX
    benchmarks replaced by fixed results (nothing of JAX runs)."""
    import bench as root_bench

    monkeypatch.setattr(JB, "bench_myers", lambda n_pairs: {"gcups": 1.0})
    monkeypatch.setattr(JB, "bench_sw",
                        lambda n_pairs: {"gcups": 2.0, "impl": "pallas"})
    assert root_bench.main() == 0
    return list(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


def test_bench_entry_prints_the_root_bench_line(monkeypatch, capsys):
    """`python -m hga_tpu_torch.bench --device cpu` (its main(), here at 8
    pairs a benchmark): one JSON line with the root bench.py's keys in its
    order, from bench_myers(n_pairs=8192) and bench_sw(n_pairs=4096),
    vs_baseline = value / baseline_gcups (0.7 of the H100 roofline)."""
    from hga_tpu_torch import bench as TBENCH

    keys = _root_bench_keys(monkeypatch, capsys)
    asked, results = {}, {}

    def small(name, fn):
        def f(n_pairs, device):
            asked[name] = n_pairs
            results[name] = fn(n_pairs=8, device=device)
            return results[name]
        return f

    monkeypatch.setattr(TBENCH, "bench_myers", small("myers", TB.bench_myers))
    monkeypatch.setattr(TBENCH, "bench_sw", small("sw", TB.bench_sw))
    assert TBENCH.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1                      # no card line on the CPU
    line = json.loads(out[0])
    assert list(line) == keys == ["metric", "value", "unit", "vs_baseline",
                                  "scored_sw_gcups", "scored_sw_impl"]
    assert asked == {"myers": 8192, "sw": 4096}
    my = results["myers"]
    assert line["metric"] == "overlap_dp_gcups_per_chip"
    assert line["unit"] == "GCUPS" and line["scored_sw_impl"] == "plain"
    assert line["value"] == round(my["gcups"], 3) > 0
    assert line["vs_baseline"] == round(my["gcups"] / my["baseline_gcups"],
                                        4)
    assert my["baseline_gcups"] == pytest.approx(0.7 * my["roofline_gcups"])
    assert line["scored_sw_gcups"] == round(results["sw"]["gcups"], 3)


def test_bench_entry_keeps_the_headline_when_sw_fails(monkeypatch, capsys):
    """A secondary engine that raises becomes scored_sw_error, as in the
    root bench.py; vs_baseline divides by the result's baseline_gcups."""
    from hga_tpu_torch import bench as TBENCH

    keys = _root_bench_keys(monkeypatch, capsys)

    def broken(n_pairs, device):
        raise RuntimeError("no scored SW here")

    monkeypatch.setattr(TBENCH, "bench_myers", lambda n_pairs, device: {
        "gcups": 700.0, "baseline_gcups": 1400.0})
    monkeypatch.setattr(TBENCH, "bench_sw", broken)
    assert TBENCH.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == keys[:4] + ["scored_sw_error"]
    assert (line["value"], line["vs_baseline"]) == (700.0, 0.5)
    assert "no scored SW here" in line["scored_sw_error"]
