"""L2 device ops — candidate overlap pairs from shared minimizers (PyTorch).

Counterpart of ``hga_tpu.ops.pairs.candidate_pairs``, same pair semantics:
entries (minimizer, read, pos, strand) sorted by minimizer value form runs;
every run of at most ``max_freq`` entries pairs each of its entries with
every later one (the bounded sorted self-join: runs above ``max_freq`` are
the repeat mask), pairs of one read are dropped, ``mode="cross"`` keeps only
pairs across categories; per (a, b, rel) the shared-seed count and the
median diagonal pos_a - pos_b' (pos_b' is b's seed position in orientation
rel) are kept when the count reaches ``min_shared``.  Output is ordered by
(a, b, rel) ascending.

The reference's run slots are a static (N, max_freq) unroll with a
capacity-padded output and a retry when it overflows; here the join expands
exactly the pairs each run holds, so the output always holds every kept pair.
Pairs do not depend on the order of equal minimizers within a run (a run
pairs all of its entries), so an unstable sort is as good as a stable one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hga_tpu_torch.ops.count import SENTINEL


class CandidatePairs(NamedTuple):
    """Candidate pair list (every kept pair, no padding).

    a, b:   int32 — read ids, a < b
    rel:    int32 — 0 same strand, 1 b is reverse-complemented
    diag:   int32 — median over shared seeds of pos_a - pos_b'
    shared: int32 — number of shared (frequency-filtered) minimizers
    """

    a: torch.Tensor
    b: torch.Tensor
    rel: torch.Tensor
    diag: torch.Tensor
    shared: torch.Tensor


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by keys[0], then keys[1], ... (major first)."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def candidate_pairs(
    hi: torch.Tensor,        # (N,) minimizer k-mer hi word (SENTINEL: unused)
    lo: torch.Tensor,        # (N,)
    read: torch.Tensor,      # (N,) read id per entry
    pos: torch.Tensor,       # (N,) k-mer position in the read
    strand: torch.Tensor,    # (N,) orientation that won canonicalization
    read_len: torch.Tensor,  # (R,) true length per read id
    category: torch.Tensor,  # (R,) source category per read id
    k: int,
    max_freq: int,
    min_shared: int,
    mode: str = "all",       # "all": any pair; "cross": categories differ
) -> CandidatePairs:
    i64 = torch.int64
    hi, lo = hi.to(i64), lo.to(i64)
    used = ~((hi == SENTINEL) & (lo == SENTINEL))
    key = ((hi << 32) | lo)[used]
    read, pos, strand = (x[used].to(i64) for x in (read, pos, strand))
    read_len, category = read_len.to(i64), category.to(i64)

    # ---- sorted index: runs of equal minimizers ----
    order = torch.argsort(key)
    key, read, pos, strand = key[order], read[order], pos[order], strand[order]
    n = key.numel()
    dev = key.device
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = key[1:] != key[:-1]
    run_start = torch.nonzero(is_new)[:, 0]
    run_len = torch.diff(run_start, append=torch.tensor([n], device=dev))
    run_of = torch.cumsum(is_new.to(i64), 0) - 1
    run_end = (run_start + run_len)[run_of]
    # ---- bounded self-join: entry e pairs with every later entry of its run
    take = torch.where(run_len[run_of] <= max_freq,
                       run_end - torch.arange(n, device=dev) - 1, 0)
    src = torch.repeat_interleave(torch.arange(n, device=dev), take)
    first = torch.repeat_interleave(torch.cumsum(take, 0) - take, take)
    dst = src + 1 + torch.arange(src.numel(), device=dev) - first
    ok = read[src] != read[dst]
    if mode == "cross":
        ok &= category[read[src]] != category[read[dst]]
    src, dst = src[ok], dst[ok]
    # canonical order a < b
    swap = read[src] > read[dst]
    ia = torch.where(swap, dst, src)
    ib = torch.where(swap, src, dst)
    a, b = read[ia], read[ib]
    rel = (strand[ia] != strand[ib]).to(i64)
    pb = pos[ib]
    diag = pos[ia] - torch.where(rel == 1, read_len[b] - k - pb, pb)

    # ---- aggregate per (a, b, rel): shared count + median diagonal ----
    o = _lexsort(a, b, rel, diag)
    a, b, rel, diag = a[o], b[o], rel[o], diag[o]
    m = a.numel()
    g_new = torch.ones(m, dtype=torch.bool, device=dev)
    g_new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1]) | (rel[1:] != rel[:-1])
    g_first = torch.nonzero(g_new)[:, 0]
    cnt = torch.diff(g_first, append=torch.tensor([m], device=dev))
    keep = cnt >= min_shared
    g = g_first[keep]
    i32 = lambda x: x.to(torch.int32)
    return CandidatePairs(a=i32(a[g]), b=i32(b[g]), rel=i32(rel[g]),
                          diag=i32(diag[g + cnt[keep] // 2]),
                          shared=i32(cnt[keep]))
