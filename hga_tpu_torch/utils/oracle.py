"""Host numpy helpers copied from ``hga_tpu.utils.oracle``.

Only what the port's main path and its tests need: the canonical k-mer
values of a read (evaluation), the spectrum valley threshold, the unitig
walk, and the scalar semi-global edit distance that spot-checks the Myers
engine.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

U64 = np.uint64


def kmer_values(codes: np.ndarray, bad: np.ndarray, length: int, k: int):
    """Canonical k-mers of one read.

    Returns (canon uint64[m], strand uint8[m], valid bool[m]) with
    m = max(0, length - k + 1); valid[i] is False if any base in the window is
    flagged bad.  k-mer value: first base most significant, 2 bits a base;
    canonical = min(value, reverse-complement value), strand 1 where the
    reverse complement is smaller.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    bad = np.asarray(bad, dtype=np.uint8)
    m = max(0, int(length) - k + 1)
    if m == 0:
        return (np.zeros(0, U64), np.zeros(0, np.uint8), np.zeros(0, bool))
    fwd = np.zeros(m, dtype=U64)
    rc = np.zeros(m, dtype=U64)
    for t in range(k):
        fwd |= codes[t : t + m] << U64(2 * (k - 1 - t))
        rc |= (U64(3) - codes[k - 1 - t : k - 1 - t + m]) << U64(2 * (k - 1 - t))
    canon = np.minimum(fwd, rc)
    strand = (fwd > rc).astype(np.uint8)
    badc = np.concatenate([[0], np.cumsum(bad[: int(length)], dtype=np.int64)])
    valid = (badc[k:] - badc[:-k]) == 0
    return canon, strand, valid


def solid_threshold_from_hist(hist: np.ndarray, min_threshold: int = 2) -> int:
    """Pick the valley between the error peak (count~1) and coverage peak.

    Walk up from count=min_threshold: the threshold is the first count where
    the (smoothed) histogram stops decreasing.  Falls back to min_threshold
    when no valley exists.
    """
    h = hist.astype(np.float64)
    # 3-wide smoothing to be robust to noise
    sm = h.copy()
    if len(h) > 3:
        sm[1:-1] = (h[:-2] + h[1:-1] + h[2:]) / 3.0
    for c in range(max(1, min_threshold), len(sm) - 1):
        if sm[c + 1] >= sm[c]:
            return c + 1
    return min_threshold


def unitigs_from_edges(n_nodes: int, edges: List[Tuple[int, int]]):
    """Maximal unambiguous paths (in-degree<=1, out-degree<=1 chains).

    Returns list of node paths.  Nodes with branching degree form singleton
    paths.  Deterministic: paths start from the smallest eligible node id.
    """
    from collections import defaultdict

    outd = defaultdict(list)
    ind = defaultdict(list)
    for u, v in edges:
        outd[u].append(v)
        ind[v].append(u)
    visited = np.zeros(n_nodes, dtype=bool)
    paths = []
    for s in range(n_nodes):
        if visited[s]:
            continue
        # start nodes: in-degree != 1 or predecessor is branching
        pred = ind.get(s, [])
        is_start = len(pred) != 1 or len(outd.get(pred[0], [])) != 1
        if not is_start:
            continue
        path = [s]
        visited[s] = True
        cur = s
        while len(outd.get(cur, [])) == 1:
            nxt = outd[cur][0]
            if len(ind.get(nxt, [])) != 1 or visited[nxt]:
                break
            path.append(nxt)
            visited[nxt] = True
            cur = nxt
        paths.append(path)
    # cycles: remaining unvisited nodes with degree 1 chains
    for s in range(n_nodes):
        if not visited[s]:
            path = [s]
            visited[s] = True
            cur = s
            while len(outd.get(cur, [])) == 1:
                nxt = outd[cur][0]
                if visited[nxt]:
                    break
                path.append(nxt)
                visited[nxt] = True
                cur = nxt
            paths.append(path)
    return paths


def edit_distance_hw(q, t) -> Tuple[int, int]:
    """Semi-global (infix / edlib-"HW") unit-cost edit distance.

    The whole query aligns somewhere inside the target: D[i][0] = i,
    D[0][j] = 0; returns (min_j D[m][j], argmin j) with the SMALLEST j
    breaking ties.  The scalar reference for ops/myers.py.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    m, n = len(q), len(t)
    if m == 0:
        return 0, 0
    prev = np.arange(m + 1, dtype=np.int64)  # column j=0
    best, best_j = int(prev[m]), 0
    for j in range(1, n + 1):
        cur = np.empty(m + 1, np.int64)
        cur[0] = 0
        sub = (q != t[j - 1]).astype(np.int64)
        for i in range(1, m + 1):
            cur[i] = min(prev[i - 1] + sub[i - 1], prev[i] + 1, cur[i - 1] + 1)
        if int(cur[m]) < best:
            best, best_j = int(cur[m]), j
        prev = cur
    return best, best_j
