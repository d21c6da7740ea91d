"""Seeded inputs: genomes, Illumina-like short reads, assemblies.

Vectorised NumPy copies of the port's read and repeat models
(``hga_tpu_torch/utils/sim.py``: ``random_genome``, ``repeat_genome``,
``simulate_short_reads``), kept here so that a change to the program cannot
change the yardstick.  Everything is drawn from ``np.random.Generator``
(PCG64), so one seed gives the same arrays on every machine.  Bases are
codes A=0, C=1, G=2, T=3 in uint8 arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BASES_PER_WORD = 16
MASK_BITS_PER_WORD = 32
_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
READ_CHUNK = 1 << 18


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one stream of a run: the run's seed (any whole
    number) and the stream's keys."""
    seed = int(seed)
    return np.random.default_rng(
        np.random.SeedSequence([abs(seed), int(seed < 0), *keys]))


def decode(codes: np.ndarray) -> str:
    return _DECODE[codes].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def random_genome(rng: np.random.Generator, length: int, gc: float
                  ) -> np.ndarray:
    """i.i.d. bases at the given GC share (``sim.random_genome``)."""
    p_at, p_gc = (1.0 - gc) / 2, gc / 2
    return rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at]).astype(
        np.uint8)


def repeat_genome(rng: np.random.Generator, length: int, gc: float,
                  rrna_copies: int, rrna_len: int, rrna_ident: float,
                  is_families: int, is_copies: int, is_len: int,
                  is_ident: float, tandem_loci: int, tandem_unit: int,
                  tandem_copies: int) -> Tuple[np.ndarray, List[Dict]]:
    """A genome with bacterial repeat structure (``sim.repeat_genome``):
    each family's copies are its master mutated to the family's identity,
    placed without overlap on a random strand over an i.i.d. background;
    tandem loci repeat one unit.  Returns the codes and one dict per copy
    (family, start, end, strand)."""
    g = random_genome(rng, length, gc)
    placed: List[Tuple[int, int]] = []
    copies: List[Dict] = []

    def place(L: int) -> int:
        for _ in range(200):
            s = int(rng.integers(0, max(1, length - L)))
            if all(s + L <= a or s >= b for a, b in placed):
                placed.append((s, s + L))
                return s
        return -1

    def family(name: str, n: int, L: int, ident: float) -> None:
        master = rng.integers(0, 4, size=L).astype(np.uint8)
        for _ in range(n):
            s = place(L)
            if s < 0:
                continue
            copy = master.copy()
            nmut = rng.binomial(L, max(0.0, 1.0 - ident))
            if nmut:
                pos = rng.choice(L, size=nmut, replace=False)
                copy[pos] = (copy[pos] + rng.integers(1, 4, size=nmut)) % 4
            strand = int(rng.integers(0, 2))
            if strand:
                copy = revcomp(copy)
            g[s:s + L] = copy
            copies.append(dict(family=name, start=s, end=s + L,
                               strand=strand))

    family("rrna", rrna_copies, min(rrna_len, length // 4), rrna_ident)
    for f in range(is_families):
        family(f"is{f}", is_copies, min(is_len, length // 8), is_ident)
    for t in range(tandem_loci):
        unit = rng.integers(0, 4, size=tandem_unit).astype(np.uint8)
        L = min(tandem_unit * tandem_copies, length // 8)
        s = place(L)
        if s >= 0:
            g[s:s + L] = np.tile(unit, tandem_copies)[:L]
            copies.append(dict(family=f"tandem{t}", start=s, end=s + L,
                               strand=0))
    return g, copies


def genome(rng: np.random.Generator, spec: Dict) -> np.ndarray:
    """The genome a configuration's ``genome`` entry describes."""
    if spec["model"] == "random":
        return random_genome(rng, spec["length"], spec["gc"])
    if spec["model"] == "repeats":
        return repeat_genome(rng, spec["length"], spec["gc"],
                             **spec["repeats"])[0]
    raise ValueError(f"unknown genome model {spec['model']!r}")


def pack_codes(codes: np.ndarray, pad_len: int) -> np.ndarray:
    """uint8 (n, L) codes, L <= pad_len -> uint32 (n, pad_len / 16)."""
    n, L = codes.shape
    buf = np.zeros((n, pad_len), np.uint32)
    buf[:, :L] = codes
    shifts = 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)
    return (buf.reshape(n, pad_len // BASES_PER_WORD, BASES_PER_WORD)
            << shifts).sum(axis=2, dtype=np.uint32)


def read_chunks(rng: np.random.Generator, g: np.ndarray, spec: Dict,
                circular: bool):
    """Illumina-like reads (``sim.simulate_short_reads``), READ_CHUNK at a
    time: coverage x G / read_len reads of read_len bases at uniform starts
    (across the origin of a circular genome), each base substituted with
    probability error_rate, each read reverse-complemented with probability
    1/2.  Yields (first read, codes uint8 (c, read_len), starts, strands)."""
    G, L = len(g), spec["read_len"]
    n = int(spec["coverage"] * G / L)
    starts = rng.integers(0, G if circular else max(1, G - L + 1), size=n)
    strands = rng.integers(0, 2, size=n).astype(bool)
    ar = np.arange(L)
    for c0 in range(0, n, READ_CHUNK):
        s = starts[c0:c0 + READ_CHUNK]
        idx = s[:, None] + ar
        if circular:
            idx %= G
        codes = g[idx]
        err = rng.random(codes.shape, dtype=np.float32) < spec["error_rate"]
        codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))
                      ) % 4
        rc = strands[c0:c0 + READ_CHUNK]
        codes[rc] = 3 - codes[rc, ::-1]
        yield c0, codes, s, rc


def short_reads(rng: np.random.Generator, g: np.ndarray, spec: Dict,
                circular: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """read_chunks' reads packed as the port's ``PackedReads`` holds them:
    uint32 words of 16 2-bit codes, LSB first (n, pad_len / 16); uint32
    words of 32 bad-base flags, none set (n, ceil(pad_len / 32)); int32
    lengths."""
    L, pad = spec["read_len"], spec["pad_len"]
    if pad % BASES_PER_WORD or pad < L:
        raise ValueError(f"pad_len {pad} must be a multiple of 16 and "
                         f">= the read length {L}")
    n = int(spec["coverage"] * len(g) / L)
    packed = np.empty((n, pad // BASES_PER_WORD), np.uint32)
    for c0, codes, _, _ in read_chunks(rng, g, spec, circular):
        packed[c0:c0 + len(codes)] = pack_codes(codes, pad)
    bad = np.zeros((n, -(-pad // MASK_BITS_PER_WORD)), np.uint32)
    return packed, bad, np.full(n, L, np.int32)


def assembly(rng: np.random.Generator, g: np.ndarray, spec: Dict,
             circular: bool) -> np.ndarray:
    """One finished contig of genome g: rotated at a uniform offset (a
    circular chromosome's arbitrary start), on a uniform strand, with
    edit events at edit_rate a base, each an indel with probability
    indel_share (insertion or deletion alike, indel_len[0]..indel_len[1]
    bases) and otherwise a substitution."""
    c = g
    if circular and spec["rotate"]:
        off = int(rng.integers(0, len(g)))
        c = np.concatenate([g[off:], g[:off]])
    if int(rng.integers(0, 2)):
        c = revcomp(c)
    n = int(rng.binomial(len(c), spec["edit_rate"]))
    pos = np.sort(rng.choice(len(c), size=n, replace=False))
    indel = rng.random(n) < spec["indel_share"]
    insert = rng.random(n) < 0.5
    lo, hi = spec["indel_len"]
    lens = rng.integers(lo, hi + 1, size=n)
    subs = rng.integers(1, 4, size=n)
    ins_bases = rng.integers(0, 4, size=(n, hi)).astype(np.uint8)
    out, prev = [], 0
    for e in range(n):
        p = int(pos[e])
        if p < prev:
            continue                     # inside the last deletion
        out.append(c[prev:p])
        if not indel[e]:
            out.append(np.array([(c[p] + subs[e]) % 4], np.uint8))
            prev = p + 1
        elif insert[e]:
            out.append(ins_bases[e, :lens[e]])
            prev = p
        else:
            prev = p + int(lens[e])
    out.append(c[prev:])
    return np.concatenate(out).astype(np.uint8)
