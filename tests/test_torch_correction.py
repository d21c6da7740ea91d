"""Correction and polish of the port (plane traceback votes, consensus,
correct_long_reads, polish_contigs) against the JAX package, exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import correction as JCR
from hga_tpu.models import overlap_long as JOL
from hga_tpu.models.spectrum import count_reads as jcount
from hga_tpu.ops import myers as JM
from hga_tpu.ops import pileup as JPU
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models import correction as TCR
from hga_tpu_torch.models import overlap_long as TOL
from hga_tpu_torch.ops import pileup as TPU
from hga_tpu_torch.utils import sim

KW = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
          batch_reads=128, min_overlap_score=30, min_pileup_depth=2,
          corr_batch_pairs=512, min_identity=0.75)


def _planted(rng, P=96, Lq=48, Lt=72):
    q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (P, Lt)).astype(np.int32)
    for n in range(P):
        o = int(rng.integers(0, 12))
        seg = list(q[n])
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(seg)))
            r = int(rng.integers(0, 3))
            if r == 0:
                seg[p] = (seg[p] + 1) % 4
            elif r == 1 and len(seg) > 4:
                del seg[p]
            else:
                seg.insert(p, int(rng.integers(0, 4)))
        t[n, o:o + len(seg)] = np.array(seg[:Lt - o])
    t[5, :20] = 4
    ql = np.full(P, Lq, np.int32)
    ql[:3] = [0, 31, 20]
    return q, t, ql, np.full(P, Lt, np.int32)


@pytest.mark.parametrize("weighted", [False, True])
def test_plane_traceback_votes_match_jax(weighted):
    rng = np.random.default_rng(11)
    q, t, ql, tl = _planted(rng)
    P, Lq = q.shape
    NB, Lpad, slots = 4, 128, 3
    res, pv, mv = JM.myers_batch_planes(jnp.asarray(q), jnp.asarray(t),
                                        jnp.asarray(ql), jnp.asarray(tl))
    dist, tend = np.asarray(res.dist), np.asarray(res.tend)
    qend = np.where(dist <= 0.25 * ql, ql, 0).astype(np.int32)
    bb = rng.integers(0, NB, P).astype(np.int32)
    off = rng.integers(-8, Lpad - 60, P).astype(np.int32)
    lb = np.full(P, Lpad - 10, np.int32)
    qw = (rng.integers(1, 4, (P, Lq)).astype(np.int32) if weighted else None)
    size_v = NB * Lpad * TPU.N_SYM
    size_all = size_v + NB * Lpad * slots * 4
    for steps in (None, Lq + int(0.25 * Lq) + 2):
        ref = JPU.accumulate_backbone_votes_myers(
            jnp.zeros((size_all,), jnp.int32), pv, mv, res.dist,
            jnp.asarray(qend), res.tend, jnp.asarray(q), jnp.asarray(t),
            jnp.asarray(bb), jnp.asarray(off), jnp.asarray(lb),
            None if qw is None else jnp.asarray(qw), size_v=size_v,
            lpad=Lpad, ins_slots=slots, max_steps=steps)
        t_ = lambda x: torch.from_numpy(np.array(x))
        got = TPU.accumulate_backbone_votes_myers(
            torch.zeros(size_all + 1, dtype=torch.int32), t_(pv), t_(mv),
            t_(dist), t_(qend), t_(tend), t_(q), t_(t), t_(bb), t_(off),
            t_(lb), None if qw is None else t_(qw), size_v=size_v, lpad=Lpad,
            ins_slots=slots, max_steps=steps)
        assert int(np.asarray(ref).sum()) > 1000
        np.testing.assert_array_equal(got[:size_all].numpy(), np.asarray(ref))


def test_consensus_and_insertions_match_jax():
    rng = np.random.default_rng(12)
    nb, Lpad, slots = 3, 200, 3
    size_v = nb * Lpad * TPU.N_SYM
    merged = rng.poisson(0.6, size_v + nb * Lpad * slots * 4).astype(np.int32)
    backbone = rng.integers(0, 4, nb * Lpad).astype(np.int32)
    for min_depth, cap in ((2, 4096), (3, 10)):
        rs, rn, rp = JPU.consensus_and_insertions(
            jnp.asarray(merged), jnp.asarray(backbone), min_depth=min_depth,
            size_v=size_v, ins_slots=slots, cap=cap)
        gs, gn, gp = TPU.consensus_and_insertions(
            torch.from_numpy(merged), torch.from_numpy(backbone),
            min_depth=min_depth, size_v=size_v, ins_slots=slots, cap=cap)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
        assert gn == int(rn)
        k = min(gn, cap)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(rp)[:k])
    rsym, rdep = JPU.consensus_call(jnp.asarray(merged[:size_v]),
                                    jnp.asarray(backbone), min_depth=2)
    gsym, gdep = TPU.consensus_call(torch.from_numpy(merged[:size_v]),
                                    torch.from_numpy(backbone), min_depth=2)
    np.testing.assert_array_equal(gsym.numpy(), np.asarray(rsym))
    np.testing.assert_array_equal(gdep.numpy(), np.asarray(rdep))


def test_consensus_votes_match_jax():
    """consensus_votes: invalid rows dropped, symbols clipped to 0..5,
    columns past the end dropped and negative flat indices counted from
    the end, as the reference's scatter does."""
    rng = np.random.default_rng(13)
    N, length = 400, 50
    cols = rng.integers(-3, length + 3, N).astype(np.int32)
    syms = rng.integers(-2, 8, N).astype(np.int32)
    valid = rng.random(N) < 0.8
    cols[:4], syms[:4], valid[:4] = [0, length - 1, -1, length], \
        [0, 5, 2, 1], True
    ref = JPU.consensus_votes(jnp.asarray(cols), jnp.asarray(syms),
                              jnp.asarray(valid), length)
    got = TPU.consensus_votes(*map(torch.from_numpy, (cols, syms, valid)),
                              length)
    assert got.dtype == torch.int32 and got.shape == (length, TPU.N_SYM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) > N // 2


@pytest.fixture(scope="module")
def data():
    ds = sim.make_dataset(genome_len=7000, short_cov=25, long_cov=5,
                          seed=81, short_err=0.005, long_err=0.06)
    ss, sn, sq = sim.simulate_short_reads(ds.genome, coverage=25,
                                          error_rate=0.01, seed=82,
                                          return_quals=True)
    pad_l = ((max(len(s) for s in ds.long_seqs) + 31) // 32) * 32
    out = {}
    for tag, pack in (("j", jpack), ("t", tpack)):
        s = pack(ds.short_seqs, names=ds.short_names, pad_len=112)
        l = pack(ds.long_seqs, names=ds.long_names,
                 category=[1] * len(ds.long_seqs), pad_len=pad_l)
        q = pack(ss, names=sn, pad_len=112, quals=sq)
        out[tag] = (s, l, q)
    solid = jcount(out["j"][0], JCfg(**KW)).solid_set()
    jidx = JOL.build_seed_index(out["j"][0], JCfg(**KW), solid=solid)
    tidx = TOL.build_seed_index(out["t"][0], TCfg(**KW), solid=solid,
                                device="cpu")
    return ds, out, solid, jidx, tidx


@pytest.mark.parametrize("max_cols", [24_000_000, 60_000])
def test_correct_long_reads_matches_jax(data, max_cols):
    ds, out, solid, jidx, tidx = data
    cfg = dict(KW, corr_depth_cap=14, corr_rare_seed_freq=45)
    ref = JCR.correct_long_reads(out["j"][0], out["j"][1], JCfg(**cfg),
                                 max_cols=max_cols, solid=solid,
                                 seed_index=jidx)
    got = TCR.correct_long_reads(out["t"][0], out["t"][1], TCfg(**cfg),
                                 max_cols=max_cols, device="cpu",
                                 solid=solid, seed_index=tidx)
    assert got.names == ref.names and got.pad_len == ref.pad_len
    for f in ("packed", "bad", "length", "category"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.packed.shape == ref.packed.shape


def _draft(genome):
    d = list(genome)
    for p in range(75, len(d) - 100, 150):
        d[p] = "ACGT"[("ACGT".index(d[p]) + 1) % 4]
    d = "".join(d)
    return d[:500] + "A" + d[500:1200] + "GT" + d[1200:3000] + d[3004:]


@pytest.mark.parametrize("quality", [False, True])
def test_polish_contigs_matches_jax(data, quality):
    ds, out, solid, jidx, tidx = data
    contigs = [("c0", _draft(ds.genome)), ("c1", ds.genome[1000:4000])]
    cfg = dict(KW, use_quality=quality)
    reads = 2 if quality else 0
    kj = dict(solid=solid, seed_index=jidx) if not quality else {}
    kt = dict(solid=solid, seed_index=tidx) if not quality else {}
    if quality:  # own index over the quality-carrying reads
        kj["seed_index"] = JOL.build_seed_index(out["j"][2], JCfg(**cfg))
        kt["seed_index"] = TOL.build_seed_index(out["t"][2], TCfg(**cfg),
                                                device="cpu")
    ref = JCR.polish_contigs(contigs, out["j"][reads], JCfg(**cfg), **kj)
    got = TCR.polish_contigs(contigs, out["t"][reads], TCfg(**cfg),
                             device="cpu", **kt)
    assert got == ref
    if not quality:
        assert got[0][1] != contigs[0][1]
