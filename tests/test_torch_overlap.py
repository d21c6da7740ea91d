"""The short-read overlap route of the port (candidate pairs, the Myers gate,
both refine modes) against the JAX package: candidates on both routes, every
OverlapRecords array and the PAF text equal, the golden fixture, and the two
repairs of the candidate routing."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import correction as JCO
from hga_tpu.models import overlap as JO
from hga_tpu.models import overlap_long as JOL
from hga_tpu.models import seeding as JS
from hga_tpu.ops import pairs as JP
from hga_tpu_torch import convert
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.io.encode import revcomp_str
from hga_tpu_torch.io.fastq import iter_records
from hga_tpu_torch.models import correction as TCO
from hga_tpu_torch.models import overlap as TO
from hga_tpu_torch.models import overlap_long as TOL
from hga_tpu_torch.models import seeding as TS
from hga_tpu_torch.ops import align_cuda as TAC
from hga_tpu_torch.ops import pairs as TP
from hga_tpu_torch.utils import sim

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("a", "b", "rel", "score", "a_start", "a_end", "b_start", "b_end",
          "a_len", "b_len", "dist")
CAND = ("a", "b", "rel", "diag", "shared")

# tests/test_overlap_cross.CFG
KW = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
          batch_reads=128, min_overlap_len=40, min_overlap_score=60)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _placement():
    """tests/test_overlap_cross: error-free short reads at known positions,
    mixed strands, against one error-free long read."""
    genome = sim.random_genome(3000, seed=61)
    starts = list(range(0, 2900, 60))
    shorts = [revcomp_str(genome[s:s + 100]) if i % 3 == 0
              else genome[s:s + 100] for i, s in enumerate(starts)]
    return (shorts, [f"s{i}" for i in range(len(shorts))],
            [genome[500:2500]], ["l0"], 2048, KW)


def _with_errors():
    genome = sim.random_genome(4000, seed=62)
    shorts, sn = sim.simulate_short_reads(genome, coverage=8, read_len=100,
                                          error_rate=0.004, seed=63)
    longs, ln = sim.simulate_long_reads(genome, coverage=1.2, mean_len=1500,
                                        min_len=1200, error_rate=0.05,
                                        seed=64)
    return shorts, sn, longs, ln, None, dict(KW, min_overlap_score=40)


DATASETS = {"placement": _placement, "with_errors": _with_errors}


def _assert_records_equal(got, ref):
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


def _cross_reads(pack, ds):
    shorts, sn, longs, ln, pad_l, _ = ds
    return (pack(shorts, names=sn, pad_len=112),
            pack(longs, names=ln, category=[1] * len(longs), pad_len=pad_l))


@pytest.mark.parametrize("refine", ["sw", "myers"])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_compute_overlaps_cross_matches_jax(name, refine):
    ds = DATASETS[name]()
    kw = dict(ds[5], overlap_refine=refine)
    ref = JO.compute_overlaps_cross(*_cross_reads(jpack, ds), JCfg(**kw))
    jt = dict(JO.LAST_TIMINGS)
    got = TO.compute_overlaps_cross(*_cross_reads(tpack, ds), TCfg(**kw),
                                    device="cpu")
    assert ref.n > 10
    _assert_records_equal(got, ref)
    assert got.to_paf(ds[1], ds[3]) == ref.to_paf(ds[1], ds[3])
    for key in ("gate_pairs", "refine_pairs"):
        assert TO.LAST_TIMINGS[key] == jt[key]


@pytest.fixture(scope="module")
def short_set():
    genome = sim.random_genome(3000, seed=81)
    seqs, names = sim.simulate_short_reads(genome, coverage=12, read_len=100,
                                           error_rate=0.005, seed=82)
    return seqs, names


@pytest.mark.parametrize("refine", ["sw", "myers"])
def test_compute_overlaps_matches_jax(short_set, refine):
    seqs, names = short_set
    kw = dict(KW, min_overlap_score=40, overlap_refine=refine)
    jpr, tpr = (p(seqs, names=names, pad_len=112) for p in (jpack, tpack))
    jc = JS.find_candidates(jpr, JCfg(**kw))
    tc = TS.find_candidates(tpr, TCfg(**kw), device="cpu")
    for f in CAND:
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    ref = JO.compute_overlaps(jpr, jc, JCfg(**kw))
    got = TO.compute_overlaps(tpr, tc, TCfg(**kw), device="cpu")
    assert ref.n > 10
    _assert_records_equal(got, ref)
    assert got.to_paf(names, names) == ref.to_paf(names, names)


def test_compute_overlaps_at_pad_800_matches_jax():
    """780-base short reads padded to 800 (W 26, 6 kb genome, 8x): the
    candidates, records and PAF equal the JAX package's."""
    genome = sim.random_genome(6000, seed=3)
    seqs, names = sim.simulate_short_reads(genome, coverage=8, read_len=780,
                                           error_rate=0.005, seed=4)
    kw = dict(KW, min_overlap_score=40)
    jpr, tpr = (p(seqs, names=names, pad_len=800) for p in (jpack, tpack))
    jc = JS.find_candidates(jpr, JCfg(**kw))
    tc = TS.find_candidates(tpr, TCfg(**kw), device="cpu")
    for f in CAND:
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    ref = JO.compute_overlaps(jpr, jc, JCfg(**kw))
    got = TO.compute_overlaps(tpr, tc, TCfg(**kw), device="cpu")
    assert ref.n > 400
    _assert_records_equal(got, ref)
    assert got.to_paf(names, names) == ref.to_paf(names, names)


@pytest.mark.parametrize("refine", ["myers", "sw"])
def test_golden_overlaps_paf(refine):
    """tests/test_golden.py's fixture: the default refine must give the
    committed PAF byte for byte; "sw" must give the reference's PAF."""
    recs = list(iter_records(os.path.join(FIX, "short.fasta")))
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    kw = dict(k=15, w=5, band=32, batch_reads=256, min_shared_minimizers=2,
              min_overlap_len=30, overlap_refine=refine)
    pr = tpack(seqs, names=names, pad_len=112)
    ov = TO.compute_overlaps(pr, TS.find_candidates(pr, TCfg(**kw),
                                                    device="cpu"),
                             TCfg(**kw), device="cpu")
    got = ov.to_paf(names, names)
    if refine == "myers":
        with open(os.path.join(FIX, "golden_overlaps.paf")) as fh:
            assert got == fh.read()
    else:
        jpr = jpack(seqs, names=names, pad_len=112)
        ref = JO.compute_overlaps(jpr, JS.find_candidates(jpr, JCfg(**kw)),
                                  JCfg(**kw))
        assert got == ref.to_paf(names, names)
    assert ov.n > 0


def test_find_candidates_indexed_route_matches_jax(short_set, monkeypatch):
    """Forced above INDEXED_ROUTE_ENTRIES on both sides: the all-vs-all
    sorted-index route, equal to the reference's and to the self-join."""
    seqs, names = short_set
    kw = dict(KW, min_overlap_score=40)
    jpr, tpr = (p(seqs, names=names, pad_len=112) for p in (jpack, tpack))
    join = TS.find_candidates(tpr, TCfg(**kw), device="cpu")
    monkeypatch.setattr(JOL, "INDEXED_ROUTE_ENTRIES", 10)
    monkeypatch.setattr(TOL, "INDEXED_ROUTE_ENTRIES", 10)
    ref = JS.find_candidates(jpr, JCfg(**kw))
    got = TS.find_candidates(tpr, TCfg(**kw), device="cpu")
    assert got.n_pairs > 10 and got.overflow == ref.overflow == 0
    for f in CAND:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)
        np.testing.assert_array_equal(g, getattr(join, f), err_msg=f)


def test_candidates_artifact_round_trip(short_set, tmp_path):
    seqs, names = short_set
    jpr, tpr = (p(seqs, names=names, pad_len=112) for p in (jpack, tpack))
    JS.find_candidates(jpr, JCfg(**KW)).save(str(tmp_path / "j.npz"))
    TS.find_candidates(tpr, TCfg(**KW), device="cpu").save(
        str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zj.files == zt.files
    for f in zj.files:
        assert zj[f].dtype == zt[f].dtype, f
        np.testing.assert_array_equal(zj[f], zt[f], err_msg=f)
    back = convert.load_candidates(str(tmp_path / "j.npz"))
    assert back.overflow == 0 and back.n_pairs == zj["a"].size
    back = convert.load_candidates({f: zj[f] for f in zj.files})
    np.testing.assert_array_equal(back.diag, zj["diag"])


@pytest.mark.parametrize("mode", ["all", "cross"])
def test_candidate_pairs_ignore_the_order_of_equal_minimizers(mode):
    """Few distinct minimizers, many entries each: the reference's unstable
    sort may order a run any way; the pairs must not depend on it."""
    rng = np.random.default_rng(5)
    R, E = 16, 240
    read = rng.integers(0, R, E).astype(np.int32)
    hi = np.zeros(E, np.uint32)
    lo = rng.integers(0, 7, E).astype(np.uint32)
    lo[:20] = 0xFFFFFFFF                                  # unused slots
    hi[:20] = 0xFFFFFFFF
    pos = rng.integers(0, 80, E).astype(np.int32)
    strand = rng.integers(0, 2, E).astype(np.int32)
    read_len = rng.integers(90, 101, R).astype(np.int32)
    category = (np.arange(R) % 2).astype(np.int32)
    kw = dict(k=15, max_freq=64, min_shared=2)
    ref = JP.candidate_pairs(*(jnp.asarray(x) for x in (
        hi, lo, read, pos, strand, read_len, category)), pair_cap=4096,
        mode=mode, **kw)
    n = int(ref.n)
    assert n > 20 and int(ref.overflow) == 0
    for perm_seed in (0, 1, 2):
        p = np.random.default_rng(perm_seed).permutation(E)
        got = TP.candidate_pairs(*(torch.from_numpy(x.astype(np.int64))
                                   for x in (hi[p], lo[p], read[p], pos[p],
                                             strand[p], read_len, category)),
                                 mode=mode, **kw)
        for f in CAND:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f))[:n],
                                          err_msg=f)


def test_find_candidates_cross_takes_the_self_join_when_small():
    """Repair: without an index and below INDEXED_ROUTE_ENTRIES the
    reference joins both seed sets; corr_depth_cap (an indexed-route
    option) must not change these candidates."""
    ds = _with_errors()
    kw = dict(ds[5], corr_depth_cap=2)
    ref = JCO.find_candidates_cross(*_cross_reads(jpack, ds), JCfg(**kw))
    ts, tl = _cross_reads(tpack, ds)
    got = TCO.find_candidates_cross(ts, tl, TCfg(**kw), device="cpu")
    capped = TOL.find_candidates_cross_indexed(
        ts, tl, TCfg(**kw), depth_cap=2, device="cpu")
    assert len(capped[0]) < len(ref[0])
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_find_candidates_cross_indexed_routes_match_jax(monkeypatch):
    """With a seed index, or above INDEXED_ROUTE_ENTRIES, both sides take
    the sorted-index route."""
    ds = _with_errors()
    kw = dict(ds[5], corr_depth_cap=2)
    js, jl = _cross_reads(jpack, ds)
    ts, tl = _cross_reads(tpack, ds)
    ref = JCO.find_candidates_cross(
        js, jl, JCfg(**kw), seed_index=JOL.build_seed_index(js, JCfg(**kw)))
    got = TCO.find_candidates_cross(
        ts, tl, TCfg(**kw),
        seed_index=TOL.build_seed_index(ts, TCfg(**kw), device="cpu"),
        device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    monkeypatch.setattr(JCO, "INDEXED_ROUTE_ENTRIES", 10)
    monkeypatch.setattr(TOL, "INDEXED_ROUTE_ENTRIES", 10)
    ref = JCO.find_candidates_cross(js, jl, JCfg(**kw))
    got = TCO.find_candidates_cross(ts, tl, TCfg(**kw), device="cpu")
    assert len(ref[0]) > 10
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_cpu_overlaps_launch_no_kernel():
    # the CPU path runs the plain versions: no kernel launch is counted
    before = TAC.LAUNCHES["banded_sw_batch_cuda"]
    ds = _placement()
    TO.compute_overlaps_cross(*_cross_reads(tpack, ds),
                              TCfg(**dict(KW, overlap_refine="sw")),
                              device="cpu")
    assert TAC.LAUNCHES["banded_sw_batch_cuda"] == before
    assert torch.cuda.is_available() or TAC._LIB is None
