"""Copy arbitration (models/arbitration.py) of the port against the JAX
package's on the same numpy-seeded inputs: the arbitrated contigs byte for
byte, the placement and chunk tables array for array, and the pipeline's
arbitrate stage (tests/test_arbitration.py's four cases, held against the
reference instead of against the genome alone).  The contig pad does not
change the output: the reference's 512 KiB granule gives the same bases as
the port's pad rounded to 16."""

import os

import numpy as np
import pytest
import torch

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import arbitration as JA
from hga_tpu.models.pipeline import run_pipeline as jrun
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.io.encode import revcomp_str
from hga_tpu_torch.models import arbitration as TA
from hga_tpu_torch.models.overlap_long import _chain_representatives
from hga_tpu_torch.models.pipeline import run_pipeline as trun
from hga_tpu_torch.utils import sim

# tests/test_arbitration._cfg
KW = dict(k=15, w=5, band=64, min_shared_minimizers=2, min_overlap_len=200,
          min_identity=0.70, corr_batch_pairs=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutate(seq: str, pos: np.ndarray, rng) -> str:
    codes = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
    lut = {65: "CGT", 67: "AGT", 71: "ACT", 84: "ACG"}
    for p in pos:
        codes[p] = ord(lut[codes[p]][rng.integers(0, 3)])
    return codes.tobytes().decode()


def _genome_with_island(rng, n_copies=5, L_rep=3000, div=0.01, G=40_000):
    """tests/test_arbitration._genome_with_island: a genome with an
    n_copies repeat family, and the contig with copy 0's divergent sites
    reverted to the family master (the family-averaged wrong island)."""
    backbone = "".join(rng.choice(list("ACGT"), size=G))
    master = "".join(rng.choice(list("ACGT"), size=L_rep))
    gap = (G - n_copies * L_rep) // (n_copies + 1)
    cur = 0
    copies = []
    parts = []
    for _ in range(n_copies):
        parts.append(backbone[cur : cur + gap])
        cur += gap
        nmut = rng.binomial(L_rep, div)
        pos = np.sort(rng.choice(L_rep, size=nmut, replace=False))
        copies.append((len("".join(parts)), pos))
        parts.append(_mutate(master, pos, rng))
        cur += L_rep
    parts.append(backbone[cur:])
    genome = "".join(parts)
    start0, pos0 = copies[0]
    carr = np.frombuffer(genome.encode(), np.uint8).copy()
    marr = np.frombuffer(master.encode(), np.uint8)
    carr[start0 + pos0] = marr[pos0]
    return genome, carr.tobytes().decode(), start0 + pos0


def _long_reads(genome, **kw):
    ls, ln = sim.simulate_long_reads(genome, **kw)
    pad = ((max(len(s) for s in ls) + 31) // 32) * 32
    return tuple(pack(ls, names=ln, category=[1] * len(ls), pad_len=pad)
                 for pack in (jpack, tpack))


@pytest.fixture(scope="module")
def island():
    genome, contig, sites = _genome_with_island(np.random.default_rng(606))
    jl, tl = _long_reads(genome, coverage=22.0, mean_len=7000, min_len=2000,
                         error_rate=0.10, seed=9)
    jout = JA.arbitrate_contigs([("c0", contig)], jl, JCfg(**KW))
    tout = TA.arbitrate_contigs([("c0", contig)], tl, TCfg(**KW),
                                device="cpu")
    return dict(genome=genome, contig=contig, sites=sites, jl=jl, tl=tl,
                jout=jout, tout=tout)


def test_arbitration_restores_wrong_island(island):
    out = island["tout"]
    assert out == island["jout"]
    assert len(out) == 1 and out[0][0] == "c0"
    genome, contig, arb = island["genome"], island["contig"], out[0][1]
    assert arb != contig and abs(len(arb) - len(contig)) < 50
    restored = sum(genome[i - 10 : i + 11] in arb for i in island["sites"])
    assert restored >= 0.85 * len(island["sites"])


def test_placement_and_chunk_tables_match_jax(island):
    contig = island["contig"]
    pad = TA._contig_pad(len(contig))
    jc = jpack([contig], names=["c0"], category=[1], pad_len=pad)
    tc = tpack([contig], names=["c0"], category=[1], pad_len=pad)
    # arbitrate_contigs' automatic rare cap
    cap = max(6, int(1.6 * island["tl"].length.sum() / len(contig)) + 2)
    jp = JA._place_long_reads(island["jl"], jc, JCfg(**KW), cap)
    tp = TA._place_long_reads(island["tl"], tc, TCfg(**KW), cap,
                              device="cpu")
    assert jp[0].size > 100
    for a, b in zip(tp, jp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    reps = _chain_representatives(*tp, KW["min_shared_minimizers"])
    tab = [TA._chunk_table(*reps[:6], island["tl"].length.astype(np.int64),
                           tc.length.astype(np.int64), KW["k"]),
           JA._chunk_table(*reps[:6], island["jl"].length.astype(np.int64),
                           jc.length.astype(np.int64), KW["k"])]
    assert tab[0][0].size > 50
    # chunks that arbitrate_contigs drops (shorter than max(32, k)) and
    # both orientations occur
    assert (tab[0][4] - tab[0][3]).min() < max(32, KW["k"])
    assert set(np.unique(tab[0][2])) == {0, 1}
    for a, b in zip(*tab):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_output_does_not_depend_on_the_contig_pad(island, monkeypatch):
    """The reference's 512 KiB granule (an XLA compile-shape device) against
    the port's pad rounded to 16: the same arbitrated bases."""
    gran = 1 << 19
    monkeypatch.setattr(TA, "_contig_pad",
                        lambda raw: (raw + gran - 1) // gran * gran)
    out = TA.arbitrate_contigs([("c0", island["contig"])], island["tl"],
                               TCfg(**KW), device="cpu")
    assert out == island["tout"]


def test_arbitration_matches_jax_on_uneven_contigs(island):
    """Three contigs of very different lengths (one far longer than the
    others' pads): placement by contig, the vote buffer's per-contig
    layout and rel = 1 chunks on each."""
    g = island["contig"]
    contigs = [("a", g[:26_000]), ("b", g[26_000:35_000]),
               ("c", revcomp_str(g[35_000:]))]
    jout = JA.arbitrate_contigs(contigs, island["jl"], JCfg(**KW))
    tout = TA.arbitrate_contigs(contigs, island["tl"], TCfg(**KW),
                                device="cpu")
    assert tout == jout
    assert [n for n, _ in tout] == ["a", "b", "c"]


def test_arbitration_noop_on_clean_contig():
    genome = "".join(np.random.default_rng(707).choice(list("ACGT"),
                                                       size=20_000))
    jl, tl = _long_reads(genome, coverage=20.0, mean_len=6000, min_len=1500,
                         error_rate=0.10, seed=11)
    jout = JA.arbitrate_contigs([("c0", genome)], jl, JCfg(**KW))
    tout = TA.arbitrate_contigs([("c0", genome)], tl, TCfg(**KW),
                                device="cpu")
    assert tout == jout
    k = 21
    gk = {genome[i : i + k] for i in range(len(genome) - k + 1)}
    arb = tout[0][1]
    assert sum(arb[i : i + k] not in gk for i in range(len(arb) - k + 1)) \
        <= 60


def test_arbitration_empty_inputs():
    cs = [("c", "ACGT" * 100)]
    for pack, arb, cfg, kw in ((jpack, JA.arbitrate_contigs, JCfg(**KW), {}),
                               (tpack, TA.arbitrate_contigs, TCfg(**KW),
                                dict(device="cpu"))):
        pr = pack(["ACGT" * 40], pad_len=160)
        assert arb([], pr, cfg, **kw) == []
        assert arb(cs, pack([], pad_len=64), cfg, **kw) == cs


def test_pipeline_publishes_arbitrate_stage(tmp_path):
    """tests/test_arbitration's pipeline case on both packages: the stage
    runs between assembly and polish under the default config, writes
    arbitrated.fasta equal to the reference's and publishes its split; the
    off switch removes it."""
    ds = sim.make_dataset(genome_len=15_000, short_cov=20, long_cov=10,
                          seed=21, short_err=0.005, long_err=0.08)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    reads = lambda pack: (
        pack(ds.short_seqs, names=ds.short_names, pad_len=112),
        pack(ds.long_seqs, names=ds.long_names,
             category=[1] * len(ds.long_seqs), pad_len=pad))
    kw = dict(k=15, w=5, band=48, batch_reads=512, min_shared_minimizers=2,
              min_overlap_len=300)
    assert TCfg(**kw).arbitrate
    for arbitrate in (True, False):
        cfg = dict(kw, arbitrate=arbitrate)
        jdir, tdir = (str(tmp_path / f"{p}_{arbitrate}")
                      for p in ("jax", "torch"))
        jres = jrun(*reads(jpack), JCfg(**cfg), jdir, mesh=None)
        tres = trun(*reads(tpack), TCfg(**cfg), tdir, device="cpu")
        assert tres.polished and tres.polished == jres.polished
        assert set(tres.stats["stages"]) == set(jres.stats["stages"])
        files = ("contigs.fasta", "polished.fasta") + (
            ("arbitrated.fasta",) if arbitrate else ())
        for f in files:
            a = open(os.path.join(tdir, f), "rb").read()
            b = open(os.path.join(jdir, f), "rb").read()
            assert a == b, f
        assert ("arbitrate" in tres.stats["stages"]) == arbitrate
        assert os.path.exists(os.path.join(tdir, "arbitrated.fasta")) \
            == arbitrate
        if arbitrate:
            det, jdet = (r.stats["arbitrate_detail"] for r in (tres, jres))
            assert set(det) == set(jdet) == {"place_s", "mat_s", "vote_s",
                                             "n_chunks", "rare_cap"}
            assert (det["n_chunks"], det["rare_cap"]) == \
                (jdet["n_chunks"], jdet["rare_cap"])
