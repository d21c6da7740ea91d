"""Plain placement-free segment distance: each seg-base segment of a contig
against one row that holds the reference genome, a separator and the
genome's reverse complement; the best semi-global (infix) unit-cost edit
distance of the whole segment anywhere in the row.

The distance of a segment is min over target columns j of D[m][j], where
D[i][0] = i, D[0][j] = 0 and D[i][j] = min(D[i-1][j-1] + (q_i != t_j),
D[i-1][j] + 1, D[i][j-1] + 1); j = 0 counts too (D[m][0] = m).  A code
outside 0..3 (the separator) matches nothing.  A column of D is worked
out at once for many rows of lanes: with E[0] = 0 and E[i] = min(D'[i-1]
+ cost, D'[i] + 1) from the previous column D', D[i] = min over i' <= i
of E[i'] + (i - i'), a running minimum of E - i.

The exact answer without sweeping the whole row for every segment: a
segment of qlen bases holds P = qlen // 32 disjoint 32-base pieces, and an
alignment of cost d <= P - 1 matches at least one piece exactly (an edit
touches at most one piece).  Each exact hit of a piece's first 31 bases
fixes a diagonal s = hit - offset, and an alignment of cost d through that
piece lies inside columns [s - d, s + qlen + d).  So the least distance
over windows [s - P, s + qlen + P) around every hit is exact wherever it
is below P; a segment that finds nothing below P (the one across a
circular contig's junction with the row's ends, a segment shorter than 32
bases) is swept over the whole row in column windows, each started 2 qlen
columns early (an alignment costs at most qlen, so it spans at most 2
qlen columns).

``placement="seed"`` is the control, a seeded placement: each segment is
aligned only around the first hit (lowest row position) of its first
piece that hits, and pays qlen where no piece hits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SEP = 4                 # the separator's code: matches nothing
PIECE = 32              # bases a piece; a hit is found by its first 31
KEY = 31
LANE_BLOCK = 4096
SWEEP_COLS = 8192


def two_strand_row(genome: np.ndarray) -> np.ndarray:
    """genome . separator . reverse complement(genome), int8 codes."""
    return np.concatenate([genome, [SEP], 3 - genome[::-1]]).astype(np.int8)


def cut(contig: np.ndarray, seg: int) -> Tuple[np.ndarray, np.ndarray]:
    """The contig's segments: codes (n, seg) padded with SEP, lengths."""
    n = -(-len(contig) // seg)
    q = np.full(n * seg, SEP, np.int8)
    q[:len(contig)] = contig
    ql = np.full(n, seg, np.int64)
    if n:
        ql[-1] = len(contig) - (n - 1) * seg
    return q.reshape(n, seg), ql


def _dp_best(q: torch.Tensor, ql: torch.Tensor, t: torch.Tensor,
             c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """For each lane: min of qlen and D[qlen][j] over the lane's columns
    j in [c0, c1) of target rows t (lanes, T), the DP started fresh at
    column 0 of t (free start).  q (lanes, M) codes, ql (lanes,)."""
    lanes, M = q.shape
    dev = q.device
    ar = torch.arange(M + 1, dtype=torch.int32, device=dev)
    D = ar.expand(lanes, M + 1).clone()
    best = ql.to(torch.int32).clone()
    qi = q.to(torch.int16)
    qbad = qi >= 4
    row = ql.to(torch.int64)[:, None]
    E = torch.zeros((lanes, M + 1), dtype=torch.int32, device=dev)
    for j in range(t.shape[1]):
        c = t[:, j:j + 1].to(torch.int16)
        cost = ((qi != c) | qbad | (c >= 4)).to(torch.int32)
        E[:, 1:] = torch.minimum(D[:, :-1] + cost, D[:, 1:] + 1)
        D = torch.cummin(E - ar, dim=1).values + ar
        dm = D.gather(1, row)[:, 0]
        live = (j >= c0) & (j < c1)
        best = torch.where(live, torch.minimum(best, dm), best)
    return best


def _windows(q, ql, row, lane_seg, start, width, c0, c1, dev):
    """Run _dp_best over target windows [start, start + width) of the row
    (columns past the row read as SEP), lanes in blocks."""
    Lt = row.shape[0]
    out = torch.empty(len(lane_seg), dtype=torch.int32, device=dev)
    cols = torch.arange(width, device=dev)
    for b in range(0, len(lane_seg), LANE_BLOCK):
        sl = slice(b, b + LANE_BLOCK)
        idx = start[sl, None] + cols
        t = torch.where((idx >= 0) & (idx < Lt), row[idx.clamp(0, Lt - 1)],
                        SEP)
        out[sl] = _dp_best(q[lane_seg[sl]], ql[lane_seg[sl]], t,
                           c0[sl], c1[sl])
    return out


def _sweep(q, ql, row, segs, dev):
    """Whole-row distances of segments `segs`: column windows of
    SWEEP_COLS owned columns, each started 2 M columns early."""
    Lt, M = row.shape[0], q.shape[1]
    H = 2 * M
    nwin = -(-Lt // SWEEP_COLS)
    w0 = torch.arange(nwin, device=dev) * SWEEP_COLS
    lane_seg = segs.repeat_interleave(nwin)
    own = w0.repeat(len(segs))
    start = own - H
    best = _windows(q, ql, row, lane_seg, start, SWEEP_COLS + H,
                    torch.full_like(own, H),
                    torch.full_like(own, H + SWEEP_COLS), dev)
    out = torch.full((len(segs),), 1 << 30, dtype=torch.int32, device=dev)
    pos = torch.repeat_interleave(torch.arange(len(segs), device=dev), nwin)
    return out.scatter_reduce_(0, pos, best, reduce="amin")


def _kmer_values(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Values of every k-window of a 1-d code row, and whether the window
    holds only bases 0..3."""
    m = codes.shape[0] - k + 1
    v = torch.zeros(m, dtype=torch.int64, device=codes.device)
    bad = torch.zeros(m, dtype=torch.bool, device=codes.device)
    for t in range(k):
        b = codes[t:t + m].to(torch.int64)
        v = (v << 2) | (b & 3)
        bad |= b >= 4
    return v, ~bad


def segment_distances(genome: np.ndarray, contig: np.ndarray, seg: int,
                      device="cpu", placement: str = "free") -> np.ndarray:
    """The distance of each of the contig's segments (int64, in order)."""
    dev = torch.device(device)
    qn, qln = cut(contig, seg)
    n = qn.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    row = torch.from_numpy(two_strand_row(genome)).to(dev)
    q = torch.from_numpy(qn).to(dev)
    ql = torch.from_numpy(qln).to(dev)
    Lt = row.shape[0]

    # index of the row's 31-mers
    rv, rok = _kmer_values(row, KEY)
    rpos = torch.nonzero(rok)[:, 0]
    rv, order = torch.sort(rv[rpos], stable=True)
    rpos = rpos[order]

    # every piece's first 31 bases, and its hits
    P = (ql // PIECE)
    npieces = max(1, int(P.max()))
    offs = torch.arange(npieces, device=dev) * PIECE
    pv = torch.zeros((n, npieces), dtype=torch.int64, device=dev)
    for t in range(KEY):
        pv = (pv << 2) | (q[:, offs + t].to(torch.int64) & 3)
    has = offs[None, :] < (P[:, None] * PIECE)
    lo = torch.searchsorted(rv, pv.reshape(-1), right=False)
    hi = torch.searchsorted(rv, pv.reshape(-1), right=True)
    nhit = torch.where(has.reshape(-1), hi - lo, 0)
    if placement == "seed":
        # the first piece that hits, at its lowest row position (the
        # index is sorted stably, so a run of equal values ascends)
        hits = nhit.reshape(n, npieces) > 0
        fp = torch.where(hits, torch.arange(npieces, device=dev),
                         npieces).min(dim=1).values
        lane_seg = torch.nonzero(fp < npieces)[:, 0]
        fp = fp[lane_seg]
        diag = rpos[lo[lane_seg * npieces + fp]] - offs[fp]
    else:
        lane_piece = torch.repeat_interleave(
            torch.arange(n * npieces, device=dev), nhit)
        first_of = torch.cumsum(nhit, 0) - nhit
        within = (torch.arange(len(lane_piece), device=dev)
                  - first_of[lane_piece])
        hitpos = rpos[lo[lane_piece] + within]
        span = 2 * Lt + 4 * seg
        key = torch.unique(lane_piece // npieces * span
                           + hitpos - offs[lane_piece % npieces] + 2 * seg)
        lane_seg = key // span
        diag = key % span - 2 * seg
    dist = ql.to(torch.int32).clone()
    if len(lane_seg):
        Pl = P[lane_seg]
        width = seg + 2 * int(P.max()) + 2
        start = diag - Pl - 1
        best = _windows(q, ql, row, lane_seg, start, width,
                        torch.zeros_like(start),
                        torch.full_like(start, width), dev)
        dist = dist.scatter_reduce(0, lane_seg, best, reduce="amin")
    if placement == "free":
        need = torch.nonzero(dist >= P.to(torch.int32))[:, 0]
        if len(need):
            dist[need] = _sweep(q, ql, row, need, dev)
    return dist.cpu().numpy().astype(np.int64)

