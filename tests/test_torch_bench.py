"""``hga-torch bench`` against ``hga bench`` (hga_tpu.utils.benchmarks): the
same modes, JSON keys and cell counts, a roofline computed from the H100's
constants (not the TPU's 200 GCUPS), and the modes not ported yet raise.
Run on the CPU at a few pairs; times and rates here are the CPU's."""

import json

import numpy as np
import pytest
import torch

from hga_tpu.ops.align import sw_cells as jax_sw_cells
from hga_tpu.utils import benchmarks as JB
from hga_tpu_torch.cli import main as tmain
from hga_tpu_torch.ops import align_cuda as TAC
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import benchmarks as TB

# the JAX modes' keys (hga_tpu/utils/benchmarks.py bench_pipeline, :276)
PIPELINE_KEYS = {"reads", "seconds", "reads_per_s", "contigs"}


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
    before = (dict(TMC.LAUNCHES), dict(TAC.LAUNCHES))
    _bench(capsys, "--what", "myers", "--pairs", "4")
    _bench(capsys, "--what", "sw", "--pairs", "4")
    assert (dict(TMC.LAUNCHES), dict(TAC.LAUNCHES)) == before


@pytest.mark.parametrize("what", ["correction", "scaling", "comm"])
def test_unported_modes_raise(what):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tmain(["bench", "--what", what, "--device", "cpu"])


def test_cpu_timer_measures_calls():
    calls = []
    ms = TB.time_ms(lambda x: calls.append(x), [(1,), (2,)], 3,
                    torch.device("cpu"), passes=2)
    assert ms >= 0
    # one warm-up call per input set, then reps calls a pass, cycling
    assert calls == [1, 2, 1, 2, 1, 1, 2, 1]
    assert np.isfinite(ms)
