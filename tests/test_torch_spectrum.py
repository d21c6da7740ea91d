"""Spectrum stage of the port (ops/kmer, ops/count, models/spectrum) against
the JAX package on the same numpy-seeded reads, exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models.spectrum import count_reads as jcount
from hga_tpu.ops import count as JC
from hga_tpu.ops import kmer as JK
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.io.fastq import iter_records
from hga_tpu_torch.models.spectrum import count_reads as tcount
from hga_tpu_torch.ops import count as TC
from hga_tpu_torch.ops import kmer as TK
from hga_tpu_torch.utils import sim

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _reads(seed=3, n=40):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        L = int(rng.integers(10, 70))
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
        if i % 7 == 0:                       # ambiguous bases
            p = int(rng.integers(0, L))
            s = s[:p] + "N" + s[p + 1:]
        seqs.append(s)
    return seqs


@pytest.mark.parametrize("k", [5, 15, 17, 21, 32])
def test_extract_kmers_and_hash_match_jax(k):
    seqs = [s for s in _reads() if len(s) >= 1]
    pr = jpack(seqs, pad_len=80)
    ref = JK.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                           jnp.asarray(pr.length), k)
    got = TK.extract_kmers(TK.words_to_tensor(pr.packed, "cpu"),
                           TK.words_to_tensor(pr.bad, "cpu"),
                           torch.from_numpy(pr.length), k)
    for f in ("hi", "lo", "strand", "valid"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(ref, f)).astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(
        TK.kmer_hash32(got.hi, got.lo).numpy(),
        np.asarray(JK.kmer_hash32(ref.hi, ref.lo)).astype(np.int64))


def test_count_ops_match_jax():
    rng = np.random.default_rng(5)
    n = 3000
    hi = rng.integers(0, 4, n).astype(np.uint32)
    hi[::17] = rng.integers(0, 2**32, hi[::17].size, dtype=np.uint64)
    lo = rng.integers(0, 50, n).astype(np.uint32)
    hi[::11] = 0xFFFFFFFF                       # sentinels
    lo[::11] = 0xFFFFFFFF
    w = rng.integers(0, 3, n).astype(np.int32)
    t = lambda x: torch.from_numpy(x.astype(np.int64))
    ref = JC.sort_and_count(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w))
    got = TC.sort_and_count(t(hi), t(lo), t(w))
    assert got.n == int(ref.n)
    for f in ("hi", "lo", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy().astype(np.int64),
                                      np.asarray(getattr(ref, f)).astype(
                                          np.int64), err_msg=f)
    np.testing.assert_array_equal(
        TC.spectrum_histogram(got, 20).numpy(),
        np.asarray(JC.spectrum_histogram(ref, 20)))
    rs, gs = JC.filter_solid(ref, jnp.int32(3)), TC.filter_solid(got, 3)
    assert gs.n == int(rs.n)
    np.testing.assert_array_equal(gs.hi.numpy(), np.asarray(rs.hi))
    np.testing.assert_array_equal(gs.count.numpy(), np.asarray(rs.count))
    rm = JC.merge_counted(ref, rs)
    gm = TC.merge_counted(got, gs)
    np.testing.assert_array_equal(gm.count.numpy(), np.asarray(rm.count))
    np.testing.assert_array_equal(gm.lo.numpy(), np.asarray(rm.lo))
    qhi, qlo = hi[::3].copy(), lo[::3].copy()
    qlo[::5] += 7
    np.testing.assert_array_equal(
        TC.member_sorted(gs.hi, gs.lo, t(qhi), t(qlo)).numpy(),
        np.asarray(JC.member_sorted(rs.hi, rs.lo, jnp.asarray(qhi),
                                    jnp.asarray(qlo))))


@pytest.fixture(scope="module")
def spectra():
    ds = sim.make_dataset(genome_len=8000, short_cov=20, long_cov=0,
                          seed=61, short_err=0.01)
    kw = dict(k=15, w=5, batch_reads=256)
    pr = jpack(ds.short_seqs, names=ds.short_names, pad_len=112)
    return (jcount(pr, JCfg(**kw)),
            tcount(tpack(ds.short_seqs, names=ds.short_names, pad_len=112),
                   TCfg(**kw), device="cpu"))


def test_count_reads_matches_jax(spectra, tmp_path):
    ref, got = spectra
    assert got.threshold == ref.threshold and got.k == ref.k
    assert got.n_distinct == ref.n_distinct
    for f in ("hi", "lo", "count", "hist"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(got.solid_set(), ref.solid_set()):
        np.testing.assert_array_equal(a, b)
    ref.save(str(tmp_path / "j.npz"))
    got.save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert zj.files == zt.files
    for f in zj.files:
        np.testing.assert_array_equal(zj[f], zt[f])


def test_golden_spectrum():
    recs = list(iter_records(os.path.join(FIX, "short.fasta")))
    pr = tpack([r.seq for r in recs], names=[r.name for r in recs],
               pad_len=112)
    cfg = TCfg(k=15, w=5, band=32, batch_reads=256,
               min_shared_minimizers=2, min_overlap_len=30)
    spec = tcount(pr, cfg, device="cpu")
    got = "".join(f"{c}\t{int(n)}\n" for c, n in enumerate(spec.hist))
    with open(os.path.join(FIX, "golden_spectrum.tsv")) as fh:
        assert got == fh.read()


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU behaviour")
    pr = tpack(["ACGTACGTACGTACGTACGT"], pad_len=32)
    with pytest.raises(RuntimeError, match="cuda"):
        tcount(pr, TCfg(k=15, w=5), device="cuda")
