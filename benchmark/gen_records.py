"""Seeded multi-record genomes and their assemblies: a chromosome and
plasmids, each circular or linear, with one IS family shared across them.

Built from ``gen``'s functions (``repeat_genome``, ``random_genome``,
``assembly``) and its generators, so one seed gives the same arrays on
every machine.  A genome is a list of records ``(name, codes uint8,
circular)`` in the configuration's order; an assembly is one contig a
record, each made by ``gen.assembly`` (rotated where circular, on a
random strand, with edits), in a shuffled order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark import gen

Record = Tuple[str, np.ndarray, bool]


def record_lengths(spec: Dict) -> List[int]:
    """Each record's length.  ``spec["length"]`` is the records' total; a
    smaller total (a cut for the CPU tests) scales every record by the same
    factor, to at least one base."""
    lens = [r["length"] for r in spec["records"]]
    total = sum(lens)
    if spec["length"] >= total:
        return lens
    return [max(1, int(L * spec["length"] / total)) for L in lens]


def _place(rng: np.random.Generator, length: int, L: int,
           placed: List[Tuple[int, int]]) -> int:
    """A start for L bases that overlaps nothing placed, or -1 (as
    gen.repeat_genome places its copies)."""
    for _ in range(200):
        s = int(rng.integers(0, max(1, length - L)))
        if all(s + L <= a or s >= b for a, b in placed):
            placed.append((s, s + L))
            return s
    return -1


def genome(rng: np.random.Generator, spec: Dict) -> List[Record]:
    """The records a configuration's ``genome`` entry (model "records")
    describes: the record marked ``repeats`` through gen.repeat_genome
    with ``spec["repeats"]``, the others i.i.d. at their GC share; then
    the shared IS family's master, its copies mutated to its identity,
    placed on a random strand over nothing placed before, copies a record
    as ``shared_is["copies"]`` says."""
    if spec["model"] != "records":
        raise ValueError(f"not a genome of records: {spec['model']!r}")
    recs: List[Record] = []
    placed: Dict[str, List[Tuple[int, int]]] = {}
    for r, L in zip(spec["records"], record_lengths(spec)):
        if r.get("repeats"):
            g, copies = gen.repeat_genome(rng, L, r["gc"], **spec["repeats"])
            placed[r["name"]] = [(c["start"], c["end"]) for c in copies]
        else:
            g = gen.random_genome(rng, L, r["gc"])
            placed[r["name"]] = []
        recs.append((r["name"], g, bool(r["circular"])))
    fam = spec["shared_is"]
    master = rng.integers(0, 4, size=fam["len"]).astype(np.uint8)
    for name, g, _ in recs:
        L = min(fam["len"], len(g) // 8)
        for _ in range(fam["copies"].get(name, 0) if L else 0):
            s = _place(rng, len(g), L, placed[name])
            if s < 0:
                continue
            copy = master[:L].copy()
            nmut = rng.binomial(L, 1.0 - fam["ident"])
            if nmut:
                pos = rng.choice(L, size=nmut, replace=False)
                copy[pos] = (copy[pos] + rng.integers(1, 4, size=nmut)) % 4
            if int(rng.integers(0, 2)):
                copy = gen.revcomp(copy)
            g[s:s + L] = copy
    return recs


def assembly(rng: np.random.Generator, recs: List[Record], spec: Dict
             ) -> List[np.ndarray]:
    """One finished contig a record (gen.assembly: rotated at a uniform
    offset where the record is circular, on a uniform strand, with edit
    events at edit_rate a base), in a uniformly shuffled order."""
    contigs = [gen.assembly(rng, g, spec, circ) for _, g, circ in recs]
    return [contigs[j] for j in rng.permutation(len(contigs))]
