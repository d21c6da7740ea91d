"""The scored-SW correction engine (corr_engine="sw") of the port against the
JAX package: the dirs wavefront DP (ops/align.banded_sw_batch_dirs), the
dirs traceback (ops/pileup.traceback_columns) and its vote scatter
(ops/pileup.accumulate_backbone_votes_merged) array-equal at bands 0, 16,
64 and >= Lq on rows with qlen/tlen 0, sentinel codes, planted indels and
tied maxima; one batch's votes under three min_score gates; polish on an
error-laden draft; and the whole pipeline, every artifact byte for byte.
The JAX side runs with mesh=None (its single-device path)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import correction as JCR
from hga_tpu.models.pipeline import run_pipeline as jrun
from hga_tpu.ops import align as JA
from hga_tpu.ops import pileup as JPU
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models import correction as TCR
from hga_tpu_torch.models.pipeline import run_pipeline as trun
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import pileup as TPU
from hga_tpu_torch.utils import sim

# tests/test_correction.CFG
CFG_KW = dict(k=15, w=5, band=24, min_shared_minimizers=2, batch_reads=128,
              pad_len=256, min_overlap_len=32, max_seed_freq=64,
              min_overlap_score=30, corr_batch_pairs=1024)
# tests/test_pipeline_cli.CFG (copy arbitration at its default, on)
PIPE_KW = dict(k=15, w=5, band=24, max_seed_freq=64,
               min_shared_minimizers=2, batch_reads=256, min_overlap_len=30,
               min_overlap_score=40, min_contig_len=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate(rng, seg, n_edits):
    seg = list(seg)
    for _ in range(n_edits):
        p = int(rng.integers(0, len(seg)))
        r = int(rng.integers(0, 3))
        if r == 0:
            seg[p] = (seg[p] + 1) % 4
        elif r == 1 and len(seg) > 4:
            del seg[p]
        else:
            seg.insert(p, int(rng.integers(0, 4)))
    return seg


def sw_rows(seed, P, Lq, Lt):
    """Rows of every kind the engine meets: planted noisy copies with
    indels at offsets 0-12 (as tests/test_traceback_device.py), random
    rows, qlen 0, tlen 0, sentinel codes (4 and -1 in the query, 4 and 9
    in the target), and tied maxima: a homopolymer pair, and a query M + N
    against a target N + M (16 bases each side), whose two best cells
    (8, 16) and (16, 8) share an anti-diagonal and a score."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (P, Lt)).astype(np.int32)
    ql = np.full(P, Lq, np.int32)
    tl = np.full(P, Lt, np.int32)
    for n in range(P // 2):
        o = int(rng.integers(0, 13))
        seg = _mutate(rng, q[n], int(rng.integers(0, 5)))
        t[n, o:o + len(seg)] = np.array(seg[:Lt - o])
    ql[P // 2:] = rng.integers(1, Lq + 1, P - P // 2)
    tl[P // 2:] = rng.integers(1, Lt + 1, P - P // 2)
    ql[-1] = 0
    tl[-2] = 0
    q[-3, ::7] = 4
    q[-3, 3::11] = -1
    t[-3, ::5] = 4
    t[-3, 2::13] = 9
    q[-4] = 0
    t[-4] = 0
    t[-5, :8] = q[-5, 8:16]
    t[-5, 8:16] = q[-5, :8]
    ql[-5] = tl[-5] = 16
    return q, t, ql, tl


BANDS = [0, 16, 64, 100]          # 100 >= Lq
P, LQ, LT = 24, 40, 72


def _dirs_both(band, seed=3):
    q, t, ql, tl = sw_rows(seed, P, LQ, LT)
    rj, dj = JA.banded_sw_batch_dirs(jnp.asarray(q), jnp.asarray(t),
                                     jnp.asarray(ql), jnp.asarray(tl),
                                     band=band)
    rt, dt = TA.banded_sw_batch_dirs(*map(torch.from_numpy, (q, t, ql, tl)),
                                     band=band)
    return q, (rj, dj), (rt, dt)


@pytest.mark.parametrize("band", BANDS)
def test_dirs_dp_matches_jax(band):
    q, (rj, dj), (rt, dt) = _dirs_both(band)
    for f in ("score", "qend", "tend"):
        a, b = np.asarray(getattr(rj, f)), getattr(rt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.asarray(dj).dtype == dt.numpy().dtype == np.int8
    assert np.array_equal(np.asarray(dj), dt.numpy())
    assert int(np.asarray(rj.score).max()) > 0
    if band >= 16:
        # the planted rows align end to end; of the tied cells the one with
        # the smallest slot (smallest i) wins
        assert (np.asarray(rj.score)[:P // 2] > LQ).all()
        assert (int(rt.score[-5]), int(rt.qend[-5]),
                int(rt.tend[-5])) == (16, 8, 16)


@pytest.mark.parametrize("band", BANDS)
def test_traceback_columns_match_jax(band):
    q, (rj, dj), (rt, dt) = _dirs_both(band)
    oj = JPU.traceback_columns(dj, rj.qend, rj.tend, jnp.asarray(q),
                               band=band, Lt=LT)
    ot = TPU.traceback_columns(dt, rt.qend, rt.tend, torch.from_numpy(q),
                               band=band, Lt=LT)
    assert len(oj) == len(ot) == 7
    for a, b in zip(oj, ot):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == (LQ + LT, P)
        assert np.array_equal(a, b)
    assert np.asarray(oj[2]).any()


@pytest.mark.parametrize("band", BANDS)
def test_merged_votes_match_jax(band):
    q, (rj, dj), (rt, dt) = _dirs_both(band)
    rng = np.random.default_rng(band)
    nb, lpad = 3, 96
    bb = rng.integers(0, nb, P).astype(np.int32)
    off = rng.integers(-12, lpad - LT + 12, P).astype(np.int32)
    lb = rng.integers(lpad // 2, lpad + 1, P).astype(np.int32)
    size_v = nb * lpad * JPU.N_SYM
    size_all = size_v + nb * lpad * 3 * 4
    qend = np.where(np.asarray(rj.score) >= 10, np.asarray(rj.qend), 0)
    qend = qend.astype(np.int32)
    mj = JPU.accumulate_backbone_votes_merged(
        jnp.zeros(size_all, jnp.int32), dj, jnp.asarray(qend), rj.tend,
        jnp.asarray(q), jnp.asarray(bb), jnp.asarray(off), jnp.asarray(lb),
        size_v=size_v, lpad=lpad, band=band, Lt=LT)
    mt = TPU.accumulate_backbone_votes_merged(
        torch.zeros(size_all + 1, dtype=torch.int32), dt,
        torch.from_numpy(qend), rt.tend, torch.from_numpy(q),
        *map(torch.from_numpy, (bb, off, lb)), size_v=size_v, lpad=lpad,
        band=band, Lt=LT)
    assert np.array_equal(np.asarray(mj), mt[:size_all].numpy())
    if band:
        assert int(mt[:size_all].sum()) > 0


def test_two_buffer_votes_match_jax():
    """accumulate_backbone_votes, the two-buffer convenience over the merged
    scatter, on buffers that already hold votes: == the JAX function."""
    band = 16
    q, (rj, dj), (rt, dt) = _dirs_both(band, seed=5)
    rng = np.random.default_rng(55)
    nb, lpad = 3, 96
    bb = rng.integers(0, nb, P).astype(np.int32)
    off = rng.integers(-12, lpad - LT + 12, P).astype(np.int32)
    lb = rng.integers(lpad // 2, lpad + 1, P).astype(np.int32)
    votes = rng.integers(0, 3, nb * lpad * JPU.N_SYM).astype(np.int32)
    ins = rng.integers(0, 2, nb * lpad * 3 * 4).astype(np.int32)
    rv, ri = JPU.accumulate_backbone_votes(
        jnp.asarray(votes), jnp.asarray(ins), dj, rj.qend, rj.tend,
        jnp.asarray(q), jnp.asarray(bb), jnp.asarray(off), jnp.asarray(lb),
        lpad=lpad, band=band, Lt=LT)
    tv, ti = TPU.accumulate_backbone_votes(
        *map(torch.from_numpy, (votes, ins)), dt, rt.qend, rt.tend,
        torch.from_numpy(q), *map(torch.from_numpy, (bb, off, lb)),
        lpad=lpad, band=band, Lt=LT)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert int(tv.sum()) > int(votes.sum())             # votes were cast


def test_min_score_gates_votes_like_jax():
    """One correction batch through the engine's step at three score
    gates: the port's _votes_into equals the reference's
    _consensus_step_fn, and a higher gate drops votes."""
    band, Lq, nb, lpad = 24, 48, 4, 256
    Wt = Lq + band + 8
    q, t, ql, tl = sw_rows(11, 32, Lq, Wt)
    rng = np.random.default_rng(12)
    bb = rng.integers(0, nb, 32).astype(np.int32)
    off = rng.integers(0, lpad - Wt, 32).astype(np.int32)
    lb = np.full(32, lpad, np.int32)
    size_v = nb * lpad * JPU.N_SYM
    size_all = size_v + nb * lpad * TCR.INS_SLOTS * 4
    kw = dict(band=band, corr_engine="sw")
    sums = []
    for ms in (0, 40, 80):
        step = JCR._consensus_step_fn(JCfg(**kw), ms, Wt, nb, lpad,
                                      TCR.INS_SLOTS)
        mj = np.asarray(step(jnp.zeros(size_all, jnp.int32),
                             *map(jnp.asarray, (q, t, ql, tl, bb, off, lb))))
        mt = TCR._votes_into(torch.zeros(size_all + 1, dtype=torch.int32),
                             TCfg(**kw), size_v, lpad,
                             *map(torch.from_numpy,
                                  (q, t, ql, tl, bb, off, lb)),
                             min_score=ms)
        assert np.array_equal(mj, mt[:size_all].numpy()), ms
        sums.append(int(mj.sum()))
    assert sums[0] > sums[1] > sums[2] > 0
    # the default gate is cfg.min_overlap_score
    md = TCR._votes_into(torch.zeros(size_all + 1, dtype=torch.int32),
                         TCfg(**kw, min_overlap_score=40), size_v, lpad,
                         *map(torch.from_numpy, (q, t, ql, tl, bb, off, lb)))
    assert int(md[:size_all].sum()) == sums[1]


def test_sw_engine_refuses_quality_weights():
    q, t, ql, tl = sw_rows(5, 8, 16, 40)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_quality"):
        TCR._votes_into(torch.zeros(1 + 96 * 18, dtype=torch.int32),
                        TCfg(band=16, corr_engine="sw"), 96 * 6, 96,
                        *map(torch.from_numpy, (q, t, ql, tl)), z, z,
                        z + 96, torch.ones((8, 16), dtype=torch.int32))


@pytest.fixture(scope="module")
def draft():
    """tests/test_correction.py::test_engines_agree_on_polish's draft:
    substitutions every 180 bases, one deletion, one spurious insertion."""
    genome = sim.random_genome(2500, seed=47)
    reads, names = sim.simulate_short_reads(genome, coverage=25,
                                            read_len=100, error_rate=0.02,
                                            seed=48)
    d = list(genome)
    for p in range(60, 2400, 180):
        d[p] = "ACGT"[("ACGT".index(d[p]) + 1) % 4]
    del d[1200]
    d = "".join(d[:900] + ["A"] + d[900:])
    return genome, reads, names, d


@pytest.mark.parametrize("min_score", [None, 1000])
def test_polish_sw_engine_matches_jax(draft, min_score):
    genome, reads, names, d = draft
    kw = dict(CFG_KW, corr_engine="sw")
    j = JCR.polish_contigs([("c0", d)], jpack(reads, names=names,
                                              pad_len=112),
                           JCfg(**kw), mesh=None, min_score=min_score)
    t = TCR.polish_contigs([("c0", d)], tpack(reads, names=names,
                                              pad_len=112),
                           TCfg(**kw), device="cpu", min_score=min_score)
    assert t == j
    # no alignment scores 1000: no vote moves the draft
    assert t[0][1] == (genome if min_score is None else d)


def test_pipeline_sw_engine_matches_jax(tmp_path):
    ds = sim.make_dataset(genome_len=6000, short_cov=25, long_cov=6,
                          seed=50, short_err=0.002, long_err=0.05)

    def reads(pack):
        return (pack(ds.short_seqs, names=ds.short_names, pad_len=112),
                pack(ds.long_seqs, names=ds.long_names,
                     category=[1] * len(ds.long_seqs)))

    kw = dict(PIPE_KW, corr_engine="sw")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jres = jrun(*reads(jpack), JCfg(**kw), jdir, mesh=None)
    tres = trun(*reads(tpack), TCfg(**kw), tdir, device="cpu")
    assert tres.polished and tres.polished == jres.polished
    assert "arbitrate" in tres.stats["stages"]
    for f in ("contigs.fasta", "assembly.gfa", "arbitrated.fasta",
              "polished.fasta"):
        a = open(os.path.join(tdir, f), "rb").read()
        b = open(os.path.join(jdir, f), "rb").read()
        assert a == b, f
    for f in ("spectrum.npz", "corrected.npz", "overlaps.npz"):
        za, zb = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir,
                                                                      f))
        assert sorted(za.files) == sorted(zb.files), f
        for k in zb.files:
            assert np.array_equal(za[k], zb[k]), (f, k)
