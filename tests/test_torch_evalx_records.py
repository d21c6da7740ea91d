"""``segment_identity`` and ``evaluate_contigs`` on a reference of records
(a chromosome and plasmids, circular or linear): the port against the
benchmark's plain records reference (benchmark/reference/segdist_records.py)
and a brute-force DP written here, exactly in ``segment_dist``; the wrap
against a doubled circle; the spans and counters of the layout; and
``hga-torch eval`` on a multi-record FASTA with ``circular=true`` headers.
Records of 0.7-1.6 kb, segments of 64."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import segdist_records
from hga_tpu_torch.cli import main as tmain
from hga_tpu_torch.io.encode import encode_bases, revcomp_str
from hga_tpu_torch.io.fastq import read_reference, write_fasta
from hga_tpu_torch.utils import evalx as TE
from hga_tpu_torch.utils import sim
from hga_tpu_torch.utils import spans

SEG = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(s: str) -> np.ndarray:
    return encode_bases(s)[0].astype(np.int64)


def _brute(row: np.ndarray, segments) -> np.ndarray:
    """The full semi-global DP of every segment against the whole row,
    column by column and row by row (lanes = segments): D[i][0] = i,
    D[0][j] = 0, a code outside 0..3 matches nothing; the least D[m][j]
    over every column j, and D[m][0] = m."""
    ql = np.array([len(s) for s in segments])
    M = int(ql.max())
    q = np.full((len(segments), M), -1, np.int64)
    for i, s in enumerate(segments):
        q[i, :len(s)] = s
    D = np.tile(np.arange(M + 1), (len(segments), 1))
    lane = np.arange(len(segments))
    best = ql.copy()
    for c in row:
        cost = ((q != c) | (c >= 4)).astype(np.int64)
        nd = np.empty_like(D)
        nd[:, 0] = 0
        for r in range(1, M + 1):
            nd[:, r] = np.minimum(np.minimum(D[:, r - 1] + cost[:, r - 1],
                                             D[:, r] + 1), nd[:, r - 1] + 1)
        D = nd
        best = np.minimum(best, D[lane, ql])
    return best


def _segments(contigs):
    return [_codes(s[o:o + SEG]) for _, s in contigs
            for o in range(0, len(s), SEG)]


def _row(records) -> np.ndarray:
    """The row as the records' layout states it, written out here: each
    record, a circular one's first min(L, 2 SEG - 1) bases again, a
    separator (4) between two records; a separator; then the records'
    half reverse-complemented, separators kept."""
    fwd = []
    for _, s, circ in records:
        fwd += ([4] if fwd else []) + list(_codes(s)) + (
            list(_codes(s[:2 * SEG - 1])) if circ else [])
    back = [4 if c == 4 else 3 - c for c in reversed(fwd)]
    return np.array(fwd + [4] + back, np.int64)


def _edit(seq: str, rng, n: int) -> str:
    """n substitutions at distinct positions."""
    s = list(seq)
    for p in rng.choice(len(s), size=n, replace=False):
        s[p] = "ACGT"[("ACGT".index(s[p]) + int(rng.integers(1, 4))) % 4]
    return "".join(s)


def _records():
    a = sim.random_genome(1600, seed=31)
    b = sim.random_genome(1100, seed=32)
    c = sim.random_genome(700, seed=33)
    return [("chrom", a, True), ("p1", b, True), ("lin", c, False)]


def _case(name):
    rng = np.random.default_rng(40)
    recs = _records()
    (_, a, _), (_, b, _), (_, c, _) = recs
    if name == "rotated":
        # each circular record rotated across its origin, on both strands,
        # with a few substitutions
        contigs = [("a", _edit(a[700:] + a[:700], rng, 3)),
                   ("b", revcomp_str(_edit(b[1050:] + b[:1050], rng, 2)))]
    elif name == "linear":
        contigs = [("c", revcomp_str(_edit(c, rng, 2))),
                   ("c2", c[100:600])]
    elif name == "other_record":
        # a chimera: most of its segments' best hits lie in another record
        contigs = [("ab", a[:200] + b[300:900] + c[50:260])]
    else:                                   # ragged last segments
        contigs = [("r1", a[5:5 + 3 * SEG + 7]), ("r2", b[20:20 + SEG - 1]),
                   ("r3", c[:5])]
    return recs, contigs


@pytest.mark.parametrize("case", ["rotated", "linear", "other_record",
                                  "ragged"])
def test_records_equal_reference_and_brute_force(case):
    recs, contigs = _case(case)
    got = TE.segment_identity(contigs, recs, seg=SEG, batch=16, device="cpu")
    ref = segdist_records.segment_distances(
        [(_codes(s).astype(np.uint8), circ) for _, s, circ in recs],
        [_codes(s).astype(np.uint8) for _, s in contigs], SEG)
    brute = _brute(_row(recs), _segments(contigs))
    assert np.array_equal(ref, brute)
    span = sum(len(s) for _, s in contigs)
    assert got["n_segments"] == len(brute)
    assert got["segment_dist"] == int(brute.sum())
    assert got["segment_identity"] == 1.0 - int(brute.sum()) / span
    if case == "rotated":
        # the wrap is exact: the same as each record alone, on each strand,
        # a circular one doubled
        alone = [_codes(s + s if circ else s) for _, s, circ in recs]
        alone += [_codes(revcomp_str(s + s if circ else s))
                  for _, s, circ in recs]
        best = np.min([_brute(r, _segments(contigs)) for r in alone], axis=0)
        assert np.array_equal(best, brute)
        assert got["segment_dist"] == 5            # the edits alone


def test_origin_segment_pays_its_edits_only_as_records():
    """A segment across a circular record's origin costs its edits against
    the records, and more against their join as one string."""
    recs = _records()
    a = recs[0][1]
    contig = [("a", _edit(a[SEG * 3 + 20:] + a[:SEG * 3 + 20],
                          np.random.default_rng(41), 2))]
    assert TE.segment_identity(contig, recs, seg=SEG,
                               device="cpu")["segment_dist"] == 2
    joined = "".join(s for _, s, _ in recs)
    assert TE.segment_identity(contig, joined, seg=SEG,
                               device="cpu")["segment_dist"] > 2


def test_layout_spans_and_counters():
    """The row's layout (separators stay separators on the reverse strand;
    one linear record gives the one-string row, genome . sentinel .
    revcomp, bit for bit), the evaluation's span and its two counters
    (calls, and the bytes shipped: the row and each batch's codes and
    lengths), on both kinds of reference."""
    recs = _records()
    row, cols = TE.record_row(recs, SEG)
    assert np.array_equal(row, _row(recs))
    wrap = 2 * (2 * SEG - 1)
    assert cols == len(row) == 2 * (1600 + 1100 + 700 + wrap + 2) + 1
    assert (row == 4).sum() == 5
    # padded for a ring of 4 ranks: sentinels past the true columns
    row4, cols4 = TE.record_row(recs, SEG, 4)
    assert cols4 == cols and len(row4) % 4 == 0 and len(row4) - cols < 4
    assert np.array_equal(row4[:cols], row) and (row4[cols:] == 4).all()
    g = recs[0][1]
    one, one_cols = TE.record_row([("", g, False)], SEG)
    gc = _codes(g)
    assert one.dtype == np.int32 and one_cols == len(one) == 2 * len(g) + 1
    assert np.array_equal(one, np.concatenate([gc, [4], 3 - gc[::-1]]))
    contigs = [("x", recs[1][1][:300]), ("y", recs[2][1][10:80])]
    nseg = 5 + 2
    for ref, n_cols in ((recs, cols), (g, one_cols)):
        spans.reset("evalseg.")
        got = TE.segment_identity(contigs, ref, seg=SEG, batch=4,
                                  device="cpu")
        assert got["n_segments"] == nseg
        assert dict(spans.counters("evalseg.")) == {
            "evalseg.calls": 1,
            "evalseg.h2d_bytes": 4 * n_cols + 4 * nseg * (SEG + 1)}
    spans.reset("evalseg.")
    # the spans, on a profiler's trace (tiny: the profiler records every
    # op of the plain sweep)
    tiny = [("t1", g[:40], True), ("t2", g[50:80], False)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TE.segment_identity([("z", g[10:30])], tiny, seg=16, device="cpu")
    names = {e.name for e in prof.events()}
    assert {"evalseg.segment_identity", "evalseg.encode_reference",
            "evalseg.cut", "evalseg.h2d", "evalseg.sweep",
            "evalseg.reduce"} <= names
    spans.reset("evalseg.")


def test_records_through_the_cli_and_kmer_metrics(tmp_path, capsys):
    """``hga-torch eval --segs`` on a FASTA of records with circular=true
    headers gives the records' answers; the k-mer metrics take each
    record's k-mers alone, a circular one's across its origin; a FASTA of
    one linear record keeps the one-string path."""
    recs = _records()
    (_, a, _), (_, b, _), (_, c, _) = recs
    write_fasta(str(tmp_path / "ref.fasta"),
                [("chrom length=1600 circular=true", a),
                 ("p1 circular=true depth=2.1x", b), ("lin", c)])
    contigs = [("a", a[900:] + a[:900]), ("j", c[-300:] + a[:200])]
    write_fasta(str(tmp_path / "contigs.fasta"), contigs)
    assert read_reference(str(tmp_path / "ref.fasta")) == recs
    assert tmain(["eval", "--contigs", str(tmp_path / "contigs.fasta"),
                  "--reference", str(tmp_path / "ref.fasta"), "--segs",
                  "-k", "15", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = TE.evaluate_contigs(contigs, recs, k=15)
    want.update(TE.segment_identity(contigs, recs, device="cpu"))
    assert out == want
    # the rotated chromosome is whole; the join of two records is not
    ev = TE.evaluate_contigs(contigs[:1], recs, k=15)
    assert ev["identity"] == 1.0
    assert TE.evaluate_contigs(contigs[:1], a + b + c, k=15)["identity"] < 1
    ej = TE.evaluate_contigs(contigs[1:], recs, k=15)
    assert ej["identity"] == (486 - 14) / 486
    assert (TE.evaluate_contigs(contigs[1:], a + b + c, k=15)
            == TE.evaluate_contigs(contigs[1:], [("", a + b + c, False)],
                                   k=15))
    # one linear record: the plain string's answers
    write_fasta(str(tmp_path / "one.fasta"), [("g", a)])
    assert tmain(["eval", "--contigs", str(tmp_path / "contigs.fasta"),
                  "--reference", str(tmp_path / "one.fasta"), "--segs",
                  "-k", "15", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = TE.evaluate_contigs(contigs, a, k=15)
    want.update(TE.segment_identity(contigs, a, device="cpu"))
    assert out == want
