"""Synthetic genome + hybrid read-set simulator (deterministic).

A numpy-only copy of ``hga_tpu.utils.sim``: the same seeds give the same
genomes and reads, so the two packages can be fed identical inputs.

Capability parity with the reference's Python simulation scripts (SURVEY.md
C16: read simulation around art_illumina / nanopore simulators).  Everything
is seeded `np.random.default_rng`, so fixtures are reproducible and tests can
commit expectations.

Two read models:
* Illumina-like short reads: fixed length, ~1% substitution errors, random
  strand, uniform positions (optionally paired-end style coverage).
* Nanopore-like long reads: lognormal lengths, configurable error rate split
  between substitutions / insertions / deletions, random strand.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from hga_tpu_torch.io.encode import decode_bases, revcomp_str


def random_genome(length: int, seed: int = 0, gc: float = 0.5) -> str:
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    codes = rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at])
    return decode_bases(codes.astype(np.uint8))


@dataclasses.dataclass
class RepeatCopy:
    """Truth annotation for one placed repeat copy (diagnostics/tests)."""

    family: str            # e.g. "rrna", "is0", "tandem0"
    start: int             # genome interval [start, end)
    end: int
    strand: int            # 1 = placed reverse-complemented
    # genome-frame positions where THIS copy differs from the family master
    # (its copy-distinguishing sites)
    mut_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))


def repeat_genome(
    length: int,
    seed: int = 0,
    gc: float = 0.5,
    rrna_copies: int = 7,
    rrna_len: int = 5000,
    rrna_ident: float = 0.99,
    is_families: int = 3,
    is_copies: int = 5,
    is_len: int = 1200,
    is_ident: float = 0.97,
    tandem_loci: int = 2,
    tandem_unit: int = 350,
    tandem_copies: int = 6,
    return_annotation: bool = False,
):
    """Random genome with bacterial-style repeat structure (SURVEY.md
    Appendix A test-data row: *E. coli* K-12 carries 7 near-identical ~5 kb
    rRNA operons, tens of ~1.2 kb IS elements in families at 95-100%
    identity, and tandem repeats — the structures that make assembly hard).

    Repeats OVERWRITE segments of an i.i.d. random backbone, so the total
    length is exactly `length`.  Each family has one master sequence; each
    copy is the master mutated to the family identity, placed at a uniform
    position on a random strand, copies kept non-overlapping (rejection
    sampled).  Deterministic in `seed`.

    return_annotation=True returns (genome, [RepeatCopy, ...]) — the truth
    labels diagnostics and tests use to classify reads/candidates by origin
    copy and to probe copy-distinguishing sites (the randomness stream is
    identical either way).
    """
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    g = rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at]).astype(np.uint8)

    placed: List[Tuple[int, int]] = []
    annot: List[RepeatCopy] = []

    def _place(L: int) -> int:
        for _ in range(200):
            s = int(rng.integers(0, max(1, length - L)))
            if all(s + L <= a or s >= b for a, b in placed):
                placed.append((s, s + L))
                return s
        return -1                      # genome too crowded: skip this copy

    def _family(name: str, n_copies: int, L: int, ident: float) -> None:
        master = rng.integers(0, 4, size=L).astype(np.uint8)
        for _ in range(n_copies):
            s = _place(L)
            if s < 0:
                continue
            copy = master.copy()
            nmut = rng.binomial(L, max(0.0, 1.0 - ident))
            pos = np.zeros(0, np.int64)
            if nmut:
                # draw order matches the unannotated historical stream
                # exactly (mutate with the raw draw, sort only for the
                # annotation) so the genome is byte-identical either way
                pos = rng.choice(L, size=nmut, replace=False)
                _mutate_sub(copy, pos, rng)
                pos = np.sort(pos)
            strand = int(rng.integers(0, 2))
            if strand:
                copy = (3 - copy)[::-1]            # reverse-complement copy
                pos = L - 1 - pos[::-1]
            g[s : s + L] = copy
            annot.append(RepeatCopy(family=name, start=s, end=s + L,
                                    strand=strand, mut_pos=s + pos))

    _family("rrna", rrna_copies, min(rrna_len, length // 4), rrna_ident)
    for fi in range(is_families):
        _family(f"is{fi}", is_copies, min(is_len, length // 8), is_ident)
    for ti in range(tandem_loci):
        unit = rng.integers(0, 4, size=tandem_unit).astype(np.uint8)
        L = tandem_unit * tandem_copies
        s = _place(min(L, length // 8))
        if s >= 0:
            arr = np.tile(unit, tandem_copies)[: min(L, length // 8)]
            g[s : s + arr.size] = arr
            annot.append(RepeatCopy(family=f"tandem{ti}", start=s,
                                    end=s + arr.size, strand=0))
    seq = decode_bases(g)
    return (seq, annot) if return_annotation else seq


def _mutate_sub(codes: np.ndarray, pos: np.ndarray, rng) -> None:
    codes[pos] = (codes[pos] + rng.integers(1, 4, size=pos.shape[0])) % 4


def simulate_short_reads(
    genome: str,
    coverage: float = 30.0,
    read_len: int = 100,
    error_rate: float = 0.01,
    seed: int = 1,
    return_quals: bool = False,
    q_good: int = 38,
    q_err: int = 10,
    circular: bool = False,
):
    """Illumina-like reads. Returns (seqs, names); name encodes truth locus.

    circular=True samples start positions uniformly over the whole circle —
    reads may span the origin of a circular chromosome (matching the long
    reads' flag), so junction coverage equals interior coverage.

    return_quals=True additionally returns phred+33 quality strings — q_good
    everywhere, q_err at the injected error positions (the usual Illumina
    pattern: miscalls carry low quality), reversed with the read when the
    simulated strand flips.  Feeds the cfg.use_quality weighted-consensus
    path end to end.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    n_reads = int(coverage * G / read_len)
    from hga_tpu_torch.io.encode import encode_bases

    gcodes, _ = encode_bases(genome)
    seqs: List[str] = []
    names: List[str] = []
    quals: List[str] = []
    starts = rng.integers(0, G if circular else max(1, G - read_len + 1),
                          size=n_reads)
    strands = rng.integers(0, 2, size=n_reads)
    for i in range(n_reads):
        s = int(starts[i])
        if circular:
            codes = gcodes[np.arange(s, s + read_len) % G].copy()
        else:
            codes = gcodes[s : s + read_len].copy()
        nerr = rng.binomial(read_len, error_rate)
        pos = None
        if nerr:
            pos = rng.choice(read_len, size=nerr, replace=False)
            _mutate_sub(codes, pos, rng)
        seq = decode_bases(codes)
        if strands[i]:
            seq = revcomp_str(seq)
        seqs.append(seq)
        names.append(f"sr_{i}_{s}_{int(strands[i])}")
        if return_quals:
            q = np.full(read_len, q_good, np.uint8)
            if pos is not None:
                q[pos] = q_err
            if strands[i]:
                q = q[::-1]
            quals.append((q + 33).tobytes().decode("ascii"))
    if return_quals:
        return seqs, names, quals
    return seqs, names


def simulate_long_reads(
    genome: str,
    coverage: float = 20.0,
    mean_len: int = 8000,
    min_len: int = 1000,
    error_rate: float = 0.10,
    sub_frac: float = 0.4,
    ins_frac: float = 0.3,
    del_frac: float = 0.3,
    seed: int = 2,
    circular: bool = False,
) -> Tuple[List[str], List[str]]:
    """Nanopore-like long reads with sub/ins/del errors."""
    rng = np.random.default_rng(seed)
    from hga_tpu_torch.io.encode import encode_bases

    gcodes, _ = encode_bases(genome)
    G = len(genome)
    total = int(coverage * G)
    seqs: List[str] = []
    names: List[str] = []
    emitted = 0
    i = 0
    while emitted < total:
        L = int(np.clip(rng.lognormal(np.log(mean_len), 0.4), min_len, G))
        if circular:
            # reads may span the origin of a circular chromosome
            s = int(rng.integers(0, G))
            codes = gcodes[np.arange(s, s + L) % G].copy()
        else:
            s = int(rng.integers(0, max(1, G - L + 1)))
            codes = gcodes[s : s + L].copy()
        # error process: walk the read, inject errors position-wise
        out: List[int] = []
        p = 0
        while p < L:
            r = rng.random()
            if r < error_rate * sub_frac:
                out.append(int((codes[p] + rng.integers(1, 4)) % 4))
                p += 1
            elif r < error_rate * (sub_frac + ins_frac):
                out.append(int(rng.integers(0, 4)))  # insertion, don't consume
            elif r < error_rate * (sub_frac + ins_frac + del_frac):
                p += 1  # deletion
            else:
                out.append(int(codes[p]))
                p += 1
        seq = decode_bases(np.array(out, dtype=np.uint8))
        strand = int(rng.integers(0, 2))
        if strand:
            seq = revcomp_str(seq)
        seqs.append(seq)
        names.append(f"lr_{i}_{s}_{strand}_{L}")
        emitted += len(seq)
        i += 1
    return seqs, names


@dataclasses.dataclass
class SimDataset:
    genome: str
    short_seqs: List[str]
    short_names: List[str]
    long_seqs: List[str]
    long_names: List[str]
    # phred+33 quality strings for the short reads (return_quals=True) —
    # produced by the SAME simulate_short_reads call as the sequences, so
    # names/loci/qualities can never desynchronize (round-3 advisor item 4)
    short_quals: Optional[List[str]] = None


def make_dataset(
    genome_len: int = 50_000,
    short_cov: float = 30.0,
    long_cov: float = 20.0,
    seed: int = 0,
    short_err: float = 0.01,
    long_err: float = 0.10,
    return_quals: bool = False,
) -> SimDataset:
    genome = random_genome(genome_len, seed=seed)
    if return_quals:
        ss, sn, sq = simulate_short_reads(
            genome, coverage=short_cov, error_rate=short_err, seed=seed + 1,
            return_quals=True)
    else:
        ss, sn = simulate_short_reads(genome, coverage=short_cov,
                                      error_rate=short_err, seed=seed + 1)
        sq = None
    ls, ln = simulate_long_reads(
        genome,
        coverage=long_cov,
        mean_len=min(8000, max(2000, genome_len // 8)),
        error_rate=long_err,
        seed=seed + 2,
    )
    return SimDataset(genome, ss, sn, ls, ln, short_quals=sq)
