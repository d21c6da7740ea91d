"""L6 — collectives over the rank mesh (port of
``hga_tpu.parallel.collectives``).

* The four primitives the port uses — rank-ordered ``all_gather_cat``,
  ``all_reduce_sum``, ``all_to_all`` and the ring step ``ring_shift`` —
  run on the world's backend.  Under gloo a CUDA tensor is staged through
  host memory; that choice is made here, by the backend's name, and
  nowhere else.
* ``count_kmers_sharded`` — each rank counts its reads, the compacted
  (k-mer, count) lists are all_gathered and re-counted: every rank holds
  the exact global multiset.  ``spectrum_hist_sharded`` its histogram.
* ``count_kmers_bucketed`` / ``spectrum_hist_bucketed`` — owner-shard
  counting: one all_to_all routes every k-mer to the rank that owns its
  hash (owner = kmer_hash32 % P), each rank counts only its own disjoint
  bucket; the histogram is summed over ranks.
* ``route_by_bucket`` — the routing step alone.

Every function takes this rank's shard of the batch (its contiguous block
of reads or k-mers) and returns this rank's part of the result: its own
bucket (capacity P * bucket_cap, sentinel-padded) or the replicated whole.
Lanes have a fixed capacity `bucket_cap`; k-mers past it are dropped and
counted in `overflow`, summed over ranks (callers retry larger).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from hga_tpu_torch.ops import count as C
from hga_tpu_torch.ops import kmer as K
from hga_tpu_torch.parallel.mesh import Mesh


def _via_host(x: torch.Tensor) -> bool:
    """A CUDA tensor goes through host memory under gloo."""
    return x.is_cuda and dist.get_backend() == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if _via_host(x) else x.contiguous()


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated in rank order."""
    if _world_size() <= 1:
        return x
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(_world_size())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `x`, on x's device (a new tensor)."""
    if _world_size() <= 1:
        return x.clone()
    w = _wire(x).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return w.to(x.device)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Row block r of `x` (P, ...) goes to rank r; returns (P, ...) with
    row block s from rank s."""
    if _world_size() <= 1:
        return x.clone()
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w)
    return out.to(x.device)


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """Send `x` to rank r + 1 and receive rank r - 1's (mod P), on every
    rank at once: one batch_isend_irecv, so no order of sends deadlocks."""
    P = _world_size()
    if P <= 1:
        return x
    r = dist.get_rank()
    w = _wire(x)
    out = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (r + 1) % P),
           dist.P2POp(dist.irecv, out, (r - 1) % P)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


# ---------------------------------------------------------------- k-mers

def _batch_keys(packed, bad, length, k: int) -> torch.Tensor:
    """Flat canonical k-mer keys of a read block, sentinel where invalid."""
    kb = K.extract_kmers(packed, bad, length, k)
    key = C.pack_key(kb.hi, kb.lo)
    return torch.where(kb.valid, key, C.SENTINEL_KEY).reshape(-1)


def _owner_lanes(key: torch.Tensor, n_shards: int, bucket_cap: int
                 ) -> Tuple[torch.Tensor, int]:
    """Slot each valid key into the lane of its owner rank (kmer_hash32 %
    n_shards), in input order; returns the (n_shards, bucket_cap) lanes
    (sentinel-padded) and the keys that did not fit."""
    valid = key != C.SENTINEL_KEY
    hi, lo = C.unpack_key(key)
    dst = torch.where(valid, K.kmer_hash32(hi, lo) % n_shards, n_shards)
    order = torch.argsort(dst, stable=True)
    dst_s, key_s = dst[order], key[order]
    counts = torch.bincount(dst_s, minlength=n_shards + 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(key.numel(), device=key.device) - start[dst_s]
    live = dst_s < n_shards
    ok = live & (rank < bucket_cap)
    lanes = torch.full((n_shards * bucket_cap,), C.SENTINEL_KEY,
                       dtype=torch.int64, device=key.device)
    lanes[(dst_s * bucket_cap + rank)[ok]] = key_s[ok]
    overflow = int((live & (rank >= bucket_cap)).sum())
    return lanes.view(n_shards, bucket_cap), overflow


def _overflow_sum(n: int, device) -> int:
    return int(all_reduce_sum(torch.tensor([n], dtype=torch.int64,
                                           device=device))[0])


def route_by_bucket(mesh: Mesh, hi: torch.Tensor, lo: torch.Tensor,
                    bucket_cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Send each of this rank's k-mers (flat, sentinel-padded hi/lo) to its
    owner rank.  Returns the k-mers this rank owns, (hi, lo) of capacity
    P * bucket_cap, sentinel-padded, and the overflow summed over ranks."""
    key = C.pack_key(hi.reshape(-1), lo.reshape(-1))
    lanes, ovf = _owner_lanes(key, mesh.size, bucket_cap)
    got = all_to_all(lanes).reshape(-1)
    rh, rl = C.unpack_key(got)
    return rh, rl, _overflow_sum(ovf, key.device)


def count_kmers_bucketed(mesh: Mesh, packed, bad, length, k: int,
                         bucket_cap: int) -> Tuple[C.CountedKmers, int]:
    """Owner-shard k-mer counting of this rank's read block: returns the
    counts of the k-mers this rank owns (compact, capacity P * bucket_cap,
    `n` this shard's distinct count; the shards' k-mer sets are disjoint)
    and the overflow summed over ranks."""
    lanes, ovf = _owner_lanes(_batch_keys(packed, bad, length, k),
                              mesh.size, bucket_cap)
    got = all_to_all(lanes).reshape(-1)
    hi, lo = C.unpack_key(got)
    ck = C.sort_and_count(hi, lo, torch.ones_like(got))
    return ck, _overflow_sum(ovf, got.device)


def spectrum_hist_bucketed(mesh: Mesh, packed, bad, length, k: int,
                           bucket_cap: int, max_count: int
                           ) -> Tuple[torch.Tensor, int]:
    """The exact global spectrum histogram by owner-shard counting: each
    rank's histogram of its own bucket, summed over ranks (replicated),
    and the overflow."""
    ck, ovf = count_kmers_bucketed(mesh, packed, bad, length, k, bucket_cap)
    return all_reduce_sum(C.spectrum_histogram(ck, max_count)), ovf


def _local_count(packed, bad, length, k: int, cap: int) -> C.CountedKmers:
    """This rank's counted k-mers, compacted to a fixed capacity `cap`."""
    key = _batch_keys(packed, bad, length, k)
    hi, lo = C.unpack_key(key)
    ck = C.sort_and_count(hi, lo, torch.ones_like(key))
    n = key.numel()
    if cap >= n:
        pad = cap - n
        return C.CountedKmers(
            hi=torch.cat([ck.hi, ck.hi.new_full((pad,), C.SENTINEL)]),
            lo=torch.cat([ck.lo, ck.lo.new_full((pad,), C.SENTINEL)]),
            count=torch.cat([ck.count, ck.count.new_zeros(pad)]), n=ck.n)
    return C.CountedKmers(hi=ck.hi[:cap], lo=ck.lo[:cap],
                          count=ck.count[:cap], n=min(ck.n, cap))


def count_kmers_sharded(mesh: Mesh, packed, bad, length, k: int,
                        shard_cap: int) -> C.CountedKmers:
    """Exact global k-mer counts, replicated on every rank: each rank's
    counted list (capacity shard_cap; overflow shows as n == shard_cap) is
    all_gathered and re-counted."""
    local = _local_count(packed, bad, length, k, shard_cap)
    g_key = all_gather_cat(C.pack_key(local.hi, local.lo))
    g_cnt = all_gather_cat(local.count)
    hi, lo = C.unpack_key(g_key)
    return C.sort_and_count(hi, lo, g_cnt)


def spectrum_hist_sharded(mesh: Mesh, packed, bad, length, k: int,
                          shard_cap: int, max_count: int) -> torch.Tensor:
    """The global spectrum histogram through count_kmers_sharded."""
    ck = count_kmers_sharded(mesh, packed, bad, length, k, shard_cap)
    return C.spectrum_histogram(ck, max_count)
