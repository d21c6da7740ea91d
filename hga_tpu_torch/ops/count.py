"""L1 device ops — k-mer counting as sort + segment-sum (PyTorch).

Counterpart of ``hga_tpu.ops.count``.  The reference sorts (hi, lo) uint32
pairs because the TPU has no 64-bit integers; here one int64 key carries the
pair, ``key = (hi - 2^31) * 2^32 + lo``, whose signed order is the unsigned
(hi, lo) order for every k <= 32 (no overflow: the key spans exactly the int64
range).  Public results keep (hi, lo).  The empty-slot sentinel
(0xffffffff, 0xffffffff) maps to the largest key, so it sorts last.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SENTINEL = 0xFFFFFFFF
SENTINEL_KEY = (1 << 63) - 1
_HALF = 1 << 31
_WORD = 1 << 32


class CountedKmers(NamedTuple):
    """Compact sorted multiset: first n entries are distinct k-mers + counts.

    hi, lo: int64[C] (uint32 values) sorted ascending, sentinel-padded tail
    count:  int32[C] count per distinct k-mer (0 in the padded tail)
    n:      number of real distinct k-mers
    """

    hi: torch.Tensor
    lo: torch.Tensor
    count: torch.Tensor
    n: int


def pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) - _HALF) * _WORD + lo.to(torch.int64)


def unpack_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (key >> 32) + _HALF, key & (_WORD - 1)


def count_keys(key: torch.Tensor, weight: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted multiset count of int64 keys, sentinel keys ignored.

    Returns (distinct keys ascending, int64 counts), both compact.
    """
    key = key.reshape(-1)
    weight = weight.reshape(-1).to(torch.int64)
    if key.numel() == 0:
        return key, weight
    key_s, order = torch.sort(key, stable=True)
    is_new = torch.ones_like(key_s, dtype=torch.bool)
    is_new[1:] = key_s[1:] != key_s[:-1]
    run_id = torch.cumsum(is_new.to(torch.int64), 0) - 1
    heads = key_s[is_new]
    cnt = torch.zeros(heads.shape[0], dtype=torch.int64, device=key.device)
    cnt.index_add_(0, run_id, weight[order])
    real = heads != SENTINEL_KEY
    return heads[real], cnt[real]


def _padded(keys: torch.Tensor, counts: torch.Tensor, cap: int
            ) -> CountedKmers:
    n = int(keys.shape[0])
    full = torch.full((cap,), SENTINEL_KEY, dtype=torch.int64,
                      device=keys.device)
    full[:n] = keys
    cnt = torch.zeros(cap, dtype=torch.int32, device=keys.device)
    cnt[:n] = counts.to(torch.int32)
    hi, lo = unpack_key(full)
    return CountedKmers(hi=hi, lo=lo, count=cnt, n=n)


def sort_and_count(hi: torch.Tensor, lo: torch.Tensor,
                   weight: torch.Tensor) -> CountedKmers:
    """Weighted multiset count of (hi, lo) pairs; sentinel pairs ignored.

    Same contract as ``hga_tpu.ops.count.sort_and_count``: a compact
    CountedKmers of the input's capacity.
    """
    key = pack_key(hi.reshape(-1), lo.reshape(-1))
    keys, counts = count_keys(key, weight)
    return _padded(keys, counts, key.shape[0])


def merge_counted(a: CountedKmers, b: CountedKmers) -> CountedKmers:
    """Merge two compact counted sets (counts of equal k-mers add)."""
    return sort_and_count(torch.cat([a.hi, b.hi]), torch.cat([a.lo, b.lo]),
                          torch.cat([a.count, b.count]))


def spectrum_histogram(ck: CountedKmers, max_count: int) -> torch.Tensor:
    """hist[c] = #distinct k-mers with count c (clamped to max_count), int32."""
    c = torch.clamp(ck.count[:ck.n].to(torch.int64), 0, max_count)
    return torch.bincount(c, minlength=max_count + 1).to(torch.int32)


def filter_solid(ck: CountedKmers, threshold: int) -> CountedKmers:
    """Keep k-mers with count >= threshold, compacted to the front."""
    keep = ck.count[:ck.n] >= threshold
    key = pack_key(ck.hi[:ck.n], ck.lo[:ck.n])[keep]
    return _padded(key, ck.count[:ck.n][keep], ck.hi.shape[0])


def member_sorted(set_hi: torch.Tensor, set_lo: torch.Tensor,
                  q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Exact membership of each query (hi, lo) in a sentinel-padded set.

    A binary search of the sorted set keys; sentinel queries return False
    (as in ``hga_tpu.ops.count.member_sorted``).
    """
    skey, _ = torch.sort(pack_key(set_hi.reshape(-1), set_lo.reshape(-1)))
    qkey = pack_key(q_hi.reshape(-1), q_lo.reshape(-1))
    if skey.numel() == 0:
        return torch.zeros(q_hi.shape, dtype=torch.bool, device=q_hi.device)
    idx = torch.clamp(torch.searchsorted(skey, qkey), max=skey.numel() - 1)
    found = (skey[idx] == qkey) & (qkey != SENTINEL_KEY)
    return found.reshape(q_hi.shape)
