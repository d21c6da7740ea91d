"""The plain references against a brute force and against the port at a
small size, and the controls coming out not correct."""

import copy
import os

import numpy as np
import pytest

from benchmark import control, gen, harness
from benchmark.reference import segdist, spectrum

READS = dict(read_len=100, coverage=30.0, error_rate=0.01, pad_len=112)
SMALL_REPEATS = dict(rrna_copies=3, rrna_len=300, rrna_ident=0.99,
                     is_families=1, is_copies=3, is_len=150, is_ident=0.97,
                     tandem_loci=1, tandem_unit=50, tandem_copies=4)
EDITS = dict(rotate=True, edit_rate=3e-3, indel_share=0.5, indel_len=[1, 3])


def brute_segments(genome, contig, seg):
    """The full DP of every segment against the whole two-strand row."""
    row = segdist.two_strand_row(genome).astype(np.int64)
    q, ql = segdist.cut(contig, seg)
    out = []
    for i in range(len(ql)):
        m = int(ql[i])
        qq = q[i, :m].astype(np.int64)
        D = np.arange(m + 1)
        best = m
        for c in row:
            cost = ((qq != c) | (c >= 4)).astype(np.int64)
            nd = np.empty(m + 1, np.int64)
            nd[0] = 0
            for r in range(1, m + 1):
                nd[r] = min(D[r - 1] + cost[r - 1], D[r] + 1, nd[r - 1] + 1)
            D = nd
            best = min(best, int(D[m]))
        out.append(best)
    return np.array(out)


def small_case(seed):
    g, _ = gen.repeat_genome(gen.rng_for(seed, 1), 1500, 0.5,
                             **SMALL_REPEATS)
    c = gen.assembly(gen.rng_for(seed, 3), g, EDITS, True)
    return g, c


@pytest.mark.parametrize("seed", [11, 12])
def test_segment_distances_equal_brute_force(seed):
    g, c = small_case(seed)
    assert np.array_equal(segdist.segment_distances(g, c, 64),
                          brute_segments(g, c, 64))


@pytest.mark.parametrize("seed", [13, 14])
def test_segment_distances_equal_the_port(seed):
    from hga_tpu_torch.utils.evalx import segment_identity

    g, _ = gen.repeat_genome(gen.rng_for(seed, 1), 3000, 0.5,
                             **SMALL_REPEATS)
    c = gen.assembly(gen.rng_for(seed, 3), g, EDITS, True)
    d = segdist.segment_distances(g, c, 96)
    r = segment_identity([("c", gen.decode(c))], gen.decode(g), seg=96,
                         device="cpu")
    assert r["n_segments"] == len(d) and r["segment_dist"] == int(d.sum())


@pytest.mark.parametrize("seed", [21, 22])
def test_spectrum_equals_the_port(seed):
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import PackedReads
    from hga_tpu_torch.models.spectrum import count_reads

    g = gen.random_genome(gen.rng_for(seed, 1), 60_000, 0.508)
    packed, bad, length = gen.short_reads(gen.rng_for(seed, 2), g, READS,
                                          False)
    # flag a few bases as ambiguous, to hold the window rule too
    rows = gen.rng_for(seed, 4).integers(0, len(length), 300)
    bad[rows, 1] |= np.uint32(1 << 5)
    pr = PackedReads(packed, bad, length, [""] * len(length),
                     np.zeros(len(length), np.int32), 112)
    s = count_reads(pr, AssemblerConfig(k=21, batch_reads=4096),
                    device="cpu")
    r = spectrum.spectrum(packed, bad, length, 21, 255, 0)
    keys = (s.hi.astype(np.uint64) << np.uint64(32)) | s.lo.astype(np.uint64)
    assert np.array_equal(s.hist, r["hist"])
    assert s.threshold == r["threshold"] and s.n_distinct == r["distinct"]
    assert spectrum.solid_off(keys, s.count.astype(np.int64), r["keys"],
                              r["counts"]) == 0


def _small(cell):
    def override(c):
        c = copy.deepcopy(c)
        if cell.startswith("count"):
            c["genome"]["length"] = 200_000
            c["batch_reads"] = 16_384
        else:
            c["genome"]["length"] = 3000
            c["genome"]["repeats"].update(rrna_len=300, is_len=150,
                                          tandem_unit=40)
        return c
    return override


@pytest.mark.parametrize("cell", ["count.ecoli46-hybrid",
                                  "evalseg.ecoli46-repeats-circ"])
def test_control_is_not_correct(cell):
    """The control fails a number on three seeds; sound runs read 0."""
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    rows = []
    lower, upper, limits = control.readings(
        bench, cell, [31], [41, 42, 43], device="cpu",
        config_override=_small(cell), emit=rows.append)
    assert all(v <= limits[k] for k, v in lower.items())
    for r in rows:
        if r["kind"] == "control":
            assert any(v > limits[k] for k, v in r["readings"].items()), r
