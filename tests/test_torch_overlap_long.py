"""Long-read overlaps of the port (anchors, chains, device segment prep,
Myers gate) against the JAX package: equal OverlapRecords fields."""

import numpy as np
import pytest
import torch

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import overlap_long as JOL
from hga_tpu_torch import convert
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models import overlap_long as TOL
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import sim

FIELDS = ("a", "b", "rel", "score", "a_start", "a_end", "b_start", "b_end",
          "a_len", "b_len", "dist")


@pytest.fixture(scope="module")
def runs():
    genome = sim.random_genome(16_000, seed=21)
    seqs, names = sim.simulate_long_reads(
        genome, coverage=5, mean_len=5000, min_len=2500, error_rate=0.04,
        seed=22)
    pad = ((max(len(s) for s in seqs) + 15) // 16) * 16
    kw = dict(k=15, w=8, min_shared_minimizers=4, min_overlap_len=500,
              min_identity=0.80)
    out = {}
    for tag, pack, Cfg, OL, extra in (
            ("j", jpack, JCfg, JOL, {}),
            ("t", tpack, TCfg, TOL, {"device": "cpu"})):
        pr = pack(seqs, names=names, pad_len=pad)
        # seg_batch 1024: several DP batches per chunk, tail padding too
        out[tag] = OL.compute_overlaps_long(pr, Cfg(**kw), seg_batch=1024,
                                            **extra)
        out[tag + "_t"] = dict(OL.LAST_TIMINGS)
    return out


def test_overlap_records_match_jax(runs):
    ref, got = runs["j"], runs["t"]
    assert ref.n > 10
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert runs["t_t"]["n_segments"] == runs["j_t"]["n_segments"]
    assert set(runs["t_t"]) == set(runs["j_t"])


def test_overlaps_artifact_round_trip(runs, tmp_path):
    runs["j"].save(str(tmp_path / "j.npz"))
    runs["t"].save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zj.files == zt.files
    for f in zj.files:
        np.testing.assert_array_equal(zj[f], zt[f])
    back = convert.load_overlaps({f: zj[f] for f in zj.files})
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(runs["t"], f))


def test_cpu_run_launches_no_kernel(runs):
    # the CPU path runs the plain versions: no kernel launch is counted
    assert TMC.LAUNCHES["myers_batch_cuda"] == 0
    assert torch.cuda.is_available() or TMC._LIB is None
