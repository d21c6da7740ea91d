"""Plain k-mer spectrum: canonical k-mers of packed reads, their exact
counts, the histogram, the valley threshold and the solid set.

Each k-mer is one int64 value (k <= 31): the forward value built base by
base, the reverse complement's value, the smaller of the two.  A window
that runs past the read's length or covers a flagged (ambiguous) base is
not counted.  ``key_bits=32`` is the control: every k-mer is keyed by a
32-bit hash of its value, so k-mers whose hashes collide are counted as
one (the bucket reports its smallest k-mer).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

READ_BLOCK = 1 << 17
M32 = 0xFFFFFFFF


def valley_threshold(hist: np.ndarray, min_threshold: int = 2) -> int:
    """The first count from min_threshold up where the 3-wide smoothed
    histogram stops falling, plus one; min_threshold if it never does."""
    h = hist.astype(np.float64)
    sm = h.copy()
    if len(h) > 3:
        sm[1:-1] = (h[:-2] + h[1:-1] + h[2:]) / 3.0
    for c in range(max(1, min_threshold), len(sm) - 1):
        if sm[c + 1] >= sm[c]:
            return c + 1
    return min_threshold


def _block_kmers(packed: np.ndarray, bad: np.ndarray, length: np.ndarray,
                 k: int, dev: torch.device) -> torch.Tensor:
    words = torch.from_numpy(packed.astype(np.int64)).to(dev)
    n, W = words.shape
    L = W * 16
    codes = ((words[:, :, None] >> (2 * torch.arange(16, device=dev)))
             & 3).reshape(n, L)
    flags = ((torch.from_numpy(bad.astype(np.int64)).to(dev)[:, :, None]
              >> torch.arange(32, device=dev)) & 1).reshape(n, -1)[:, :L]
    m = L - k + 1
    fwd = torch.zeros((n, m), dtype=torch.int64, device=dev)
    rev = torch.zeros_like(fwd)
    for t in range(k):
        b = codes[:, t:t + m]
        fwd = (fwd << 2) | b
        rev = rev | ((3 - b) << (2 * t))
    canon = torch.minimum(fwd, rev)
    cum = torch.nn.functional.pad(torch.cumsum(flags, dim=1), (1, 0))
    clean = (cum[:, k:k + m] - cum[:, :m]) == 0
    pos = torch.arange(m, device=dev)[None, :]
    ln = torch.from_numpy(length.astype(np.int64)).to(dev)[:, None]
    return canon[clean & (pos + k <= ln)]


def hash32(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit hash of int64 values: the high half times the golden ratio
    folded into the low half, then murmur3's 32-bit finaliser, in int64
    arithmetic without overflow."""
    def mul(a, c):
        return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32

    x = (v & M32) ^ mul(v >> 32, 0x9E3779B1)
    x = x ^ (x >> 16)
    x = mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def spectrum(packed: np.ndarray, bad: np.ndarray, length: np.ndarray, k: int,
             max_count: int, solid_threshold: int, device="cpu",
             key_bits: int = 64) -> Dict:
    """The spectrum of a read set.  Returns hist (int64, max_count + 1),
    threshold, distinct, and the solid set: keys (uint64, ascending) with
    their counts (int64)."""
    if not 1 <= k <= 31:
        raise ValueError("the plain spectrum holds k-mers of k <= 31")
    dev = torch.device(device)
    parts = [_block_kmers(packed[s:s + READ_BLOCK], bad[s:s + READ_BLOCK],
                          length[s:s + READ_BLOCK], k, dev)
             for s in range(0, packed.shape[0], READ_BLOCK)]
    keys = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64,
                                                      device=dev)
    del parts
    if key_bits == 64:
        uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    elif key_bits == 32:
        h, inv, counts = torch.unique(hash32(keys), return_inverse=True,
                                      return_counts=True)
        rep = torch.full(h.shape, 1 << 62, dtype=torch.int64, device=dev)
        rep.scatter_reduce_(0, inv, keys, reduce="amin")
        uniq, order = torch.sort(rep)
        counts = counts[order]
    else:
        raise ValueError(f"key_bits {key_bits}")
    del keys
    hist = torch.bincount(torch.clamp(counts, max=max_count),
                          minlength=max_count + 1).cpu().numpy()
    thr = solid_threshold or valley_threshold(hist)
    solid = counts >= thr
    return dict(hist=hist.astype(np.int64), threshold=int(thr),
                distinct=int(uniq.shape[0]),
                keys=uniq[solid].cpu().numpy().astype(np.uint64),
                counts=counts[solid].cpu().numpy().astype(np.int64))


def solid_off(keys_a: np.ndarray, counts_a: np.ndarray, keys_b: np.ndarray,
              counts_b: np.ndarray) -> int:
    """How many solid k-mers differ between two sets: those in only one,
    and those in both with other counts."""
    common, ia, ib = np.intersect1d(keys_a, keys_b, assume_unique=True,
                                    return_indices=True)
    return int(len(keys_a) + len(keys_b) - 2 * len(common)
               + np.count_nonzero(counts_a[ia] != counts_b[ib]))
