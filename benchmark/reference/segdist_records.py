"""Plain placement-free segment distances against a reference of records:
each seg-base segment of many contigs against one row that holds every
record (a circular record followed by its own first bases again), a
separator between two records, a separator, and the reverse complement of
the records' half with its separators kept; the best semi-global unit-cost
edit distance of the whole segment anywhere in the row.

The row's forward half, record by record: the record's codes, for a
circular record its first min(L, 2 seg - 1) bases again, and one separator
(code 4, which matches nothing) before the next record.  One linear record
gives genome . separator . reverse complement, the one-string row.  A
segment of qlen <= seg bases has distance at most qlen, so an optimal
alignment spans at most 2 qlen columns; every such stretch of a circle of
at least 2 seg - 1 bases, through its origin too, lies whole in the record
and its wrap.

The distances are worked out as in ``segdist.segment_distances`` (its
helpers, unchanged): exact hits of each segment's 32-base pieces fix the
windows where any alignment below P = qlen // 32 must lie, and a segment
that finds nothing below P is swept over the whole row.  The method stays
exact with separators, because a 31-mer holding one is never indexed and a
separator column costs an edit in the DP, as everywhere else.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import segdist
from benchmark.reference.segdist import KEY, PIECE, SEP


def record_row(records: Sequence[Tuple[np.ndarray, bool]], seg: int
               ) -> np.ndarray:
    """The row of records (codes uint8, circular), int8 codes."""
    fwd: List[np.ndarray] = []
    for codes, circular in records:
        if fwd:
            fwd.append(np.array([SEP], np.int8))
        fwd.append(np.asarray(codes, np.int8))
        if circular:
            fwd.append(np.asarray(codes[:2 * seg - 1], np.int8))
    f = np.concatenate(fwd)
    back = np.where(f == SEP, SEP, 3 - f)[::-1]
    return np.concatenate([f, [SEP], back]).astype(np.int8)


def row_columns(records: Sequence[Tuple[int, bool]], seg: int) -> int:
    """The row's columns for records given as (length, circular)."""
    return 2 * sum(L + (min(L, 2 * seg - 1) if c else 0) + 1
                   for L, c in records) - 1


def row_distances(row: np.ndarray, contigs: Sequence[np.ndarray], seg: int,
                  device="cpu") -> np.ndarray:
    """The distance of each segment of each contig against `row` (int64,
    contig by contig, segments in order)."""
    dev = torch.device(device)
    cuts = [segdist.cut(c, seg) for c in contigs]
    cuts = [(q, ql) for q, ql in cuts if len(ql)]
    if not cuts:
        return np.zeros(0, np.int64)
    q = torch.from_numpy(np.concatenate([c[0] for c in cuts])).to(dev)
    ql = torch.from_numpy(np.concatenate([c[1] for c in cuts])).to(dev)
    n = q.shape[0]
    t = torch.from_numpy(np.asarray(row, np.int8)).to(dev)
    Lt = t.shape[0]

    # index of the row's 31-mers (none holding a separator)
    rv, rok = segdist._kmer_values(t, KEY)
    rpos = torch.nonzero(rok)[:, 0]
    rv, order = torch.sort(rv[rpos], stable=True)
    rpos = rpos[order]

    # each segment's 32-base pieces, their first 31 bases, and their hits
    P = ql // PIECE
    npieces = max(1, int(P.max()))
    offs = torch.arange(npieces, device=dev) * PIECE
    pv = torch.zeros((n, npieces), dtype=torch.int64, device=dev)
    for k in range(KEY):
        pv = (pv << 2) | (q[:, offs + k].to(torch.int64) & 3)
    has = offs[None, :] < (P[:, None] * PIECE)
    lo = torch.searchsorted(rv, pv.reshape(-1), right=False)
    hi = torch.searchsorted(rv, pv.reshape(-1), right=True)
    nhit = torch.where(has.reshape(-1), hi - lo, 0)
    lane_piece = torch.repeat_interleave(
        torch.arange(n * npieces, device=dev), nhit)
    first_of = torch.cumsum(nhit, 0) - nhit
    within = torch.arange(len(lane_piece), device=dev) - first_of[lane_piece]
    hitpos = rpos[lo[lane_piece] + within]
    # one window a (segment, diagonal)
    span = 2 * Lt + 4 * seg
    key = torch.unique(lane_piece // npieces * span
                       + hitpos - offs[lane_piece % npieces] + 2 * seg)
    lane_seg = key // span
    diag = key % span - 2 * seg

    dist = ql.to(torch.int32).clone()
    if len(lane_seg):
        width = seg + 2 * int(P.max()) + 2
        start = diag - P[lane_seg] - 1
        best = segdist._windows(q, ql, t, lane_seg, start, width,
                                torch.zeros_like(start),
                                torch.full_like(start, width), dev)
        dist = dist.scatter_reduce(0, lane_seg, best, reduce="amin")
    need = torch.nonzero(dist >= P.to(torch.int32))[:, 0]
    if len(need):
        dist[need] = segdist._sweep(q, ql, t, need, dev)
    return dist.cpu().numpy().astype(np.int64)


def segment_distances(records: Sequence[Tuple[np.ndarray, bool]],
                      contigs: Sequence[np.ndarray], seg: int,
                      device="cpu") -> np.ndarray:
    """Each segment's distance against the records' row."""
    return row_distances(record_row(records, seg), contigs, seg, device)


def joined_distances(records: Sequence[Tuple[np.ndarray, bool]],
                     contigs: Sequence[np.ndarray], seg: int,
                     device="cpu") -> np.ndarray:
    """The control: the records joined into one linear sequence, with no
    separator or wrap between them (genome, separator, reverse
    complement), as a reference read as one string is judged."""
    joined = np.concatenate([np.asarray(c, np.uint8) for c, _ in records])
    return row_distances(segdist.two_strand_row(joined), contigs, seg,
                         device)
