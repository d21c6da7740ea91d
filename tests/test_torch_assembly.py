"""Assembly of the port (CSR, transitive reduction, string graph, unitigs,
circular rotation, GFA) against the JAX package on the same overlaps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io import encode as JE
from hga_tpu.models import assembly as JA
from hga_tpu.models.overlap import compute_overlaps
from hga_tpu.models.overlap_long import compute_overlaps_long
from hga_tpu.models.seeding import find_candidates
from hga_tpu.ops import graph as JG
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io import encode as TE
from hga_tpu_torch.models import assembly as TA
from hga_tpu_torch.models.overlap import OverlapRecords as TRec
from hga_tpu_torch.ops import graph as TG
from hga_tpu_torch.utils import sim


def _port_inputs(pr, ov):
    """The JAX package's reads and overlaps as the port's objects."""
    tpr = TE.PackedReads(packed=pr.packed, bad=pr.bad, length=pr.length,
                         names=list(pr.names), category=pr.category,
                         pad_len=pr.pad_len)
    tov = TRec(**{f: getattr(ov, f) for f in (
        "a", "b", "rel", "score", "a_start", "a_end", "b_start", "b_end",
        "a_len", "b_len", "dist")})
    return tpr, tov


def _same_assembly(pr, ov, kw):
    ref = JA.assemble(pr, ov, JCfg(**kw))
    tpr, tov = _port_inputs(pr, ov)
    got = TA.assemble(tpr, tov, TCfg(**kw), device="cpu")
    assert got.contigs == ref.contigs
    assert got.paths == ref.paths and got.circular == ref.circular
    assert got.edges == ref.edges
    assert (got.n_edges_raw, got.n_edges_reduced, got.n_contained) == (
        ref.n_edges_raw, ref.n_edges_reduced, ref.n_contained)
    assert got.identity_floor == ref.identity_floor
    assert (got.to_gfa(tpr.names, tpr.length)
            == ref.to_gfa(pr.names, pr.length))
    return got


def test_graph_ops_match_jax():
    rng = np.random.default_rng(9)
    n_nodes, E = 60, 400
    u = rng.integers(0, n_nodes, E).astype(np.int32)
    v = rng.integers(0, n_nodes, E).astype(np.int32)
    key = u.astype(np.int64) * n_nodes + v
    _, first = np.unique(key, return_index=True)
    u, v = u[np.sort(first)], v[np.sort(first)]
    E = u.size
    ext = rng.integers(1, 300, E).astype(np.int32)
    sc = rng.integers(0, 500, E).astype(np.int32)
    valid = rng.random(E) > 0.1
    j = JG.build_csr(*(jnp.asarray(x) for x in (u, v, ext, sc, valid)),
                     n_nodes)
    t = TG.build_csr(*(torch.from_numpy(x) for x in (u, v, ext, sc, valid)),
                     n_nodes)
    for f in ("u", "v", "length", "score", "row_ptr", "deg"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for max_out, fuzz in ((16, 10), (3, 100)):
        np.testing.assert_array_equal(
            TG.transitive_reduction(t, n_nodes, max_out, fuzz).numpy(),
            np.asarray(JG.transitive_reduction(j, n_nodes, max_out, fuzz)))
    qa = rng.integers(0, n_nodes + 1, 300).astype(np.int32)
    qb = rng.integers(0, n_nodes, 300).astype(np.int32)
    qa[:50], qb[:50] = u[:50], v[:50]
    jf, jv = JG.lookup_sorted(*(jnp.asarray(x) for x in (u, v, ext, qa, qb)))
    tf, tv = TG.lookup_sorted(*(torch.from_numpy(x)
                                for x in (u, v, ext, qa, qb)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_long_read_assembly_matches_jax():
    genome = sim.random_genome(20_000, seed=31)
    seqs, names = sim.simulate_long_reads(
        genome, coverage=8, mean_len=4000, min_len=2000, error_rate=0.01,
        seed=32)
    pad = ((max(len(s) for s in seqs) + 15) // 16) * 16
    kw = dict(k=15, w=5, min_shared_minimizers=2, min_overlap_len=500,
              min_identity=0.9, min_contig_len=1000)
    pr = JE.pack_reads(seqs, names=names, pad_len=pad)
    ov = compute_overlaps_long(pr, JCfg(**kw))
    got = _same_assembly(pr, ov, kw)
    assert got.contigs


CIRC = dict(k=15, w=5, band=32, min_shared_minimizers=2, min_overlap_len=40)


@pytest.mark.parametrize("circular", [True, False])
def test_tiled_circle_matches_jax(circular):
    genome = sim.random_genome(2000, seed=11 if circular else 17)
    G = len(genome)
    if circular:
        reads = ["".join(genome[(s + i) % G] for i in range(120))
                 for s in range(0, G, 40)]
    else:
        reads = [genome[s:s + 120] for s in range(0, G - 120, 40)]
        reads.append(genome[-120:])
    pr = JE.pack_reads(reads, pad_len=128)
    ov = compute_overlaps(pr, find_candidates(pr, JCfg(**CIRC)),
                          JCfg(**CIRC), batch_pairs=1024)
    got = _same_assembly(pr, ov, CIRC)
    assert got.circular == [circular]
    if circular:
        assert got.contigs[0][0].endswith("_circular")
        assert len(got.contigs[0][1]) == G
