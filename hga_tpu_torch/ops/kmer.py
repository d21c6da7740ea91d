"""L1 device ops — unpack 2-bit reads and extract canonical k-mers (PyTorch).

Counterpart of ``hga_tpu.ops.kmer``: the whole (reads x positions) plane is
computed at once from k shifted views.  Packed words arrive as int32 or int64
tensors holding the uint32 bit patterns of ``PackedReads.packed``; k-mer
halves (hi, lo) are int64 tensors holding uint32 values, because PyTorch's
uint32 support is partial.  All 32-bit wrap-around arithmetic (the minimizer
hash) is done in int64 and masked with 0xFFFFFFFF, without ever overflowing
int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BASES_PER_WORD = 16
MASK_BITS_PER_WORD = 32
M32 = 0xFFFFFFFF


class KmerBatch(NamedTuple):
    """Canonical k-mers of a read batch; all tensors shaped (R, m)."""

    hi: torch.Tensor      # int64 — bits 32.. of the canonical k-mer value
    lo: torch.Tensor      # int64 — bits 0..31
    strand: torch.Tensor  # uint8 — 0: forward orientation won, 1: revcomp won
    valid: torch.Tensor   # bool  — in-range and no ambiguous base in window


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bit patterns."""
    return torch.from_numpy(
        np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)).to(device)


def unpack_bases(packed: torch.Tensor) -> torch.Tensor:
    """int[..., W] packed words -> int64[..., W*16] 2-bit codes (LSB-first)."""
    shifts = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int64,
                              device=packed.device)
    out = (packed.to(torch.int64)[..., None] >> shifts) & 3
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * BASES_PER_WORD)


def unpack_badmask(bad: torch.Tensor) -> torch.Tensor:
    """int[..., W] bad-base words -> int64[..., W*32] flags (0/1)."""
    shifts = torch.arange(MASK_BITS_PER_WORD, dtype=torch.int64,
                          device=bad.device)
    out = (bad.to(torch.int64)[..., None] >> shifts) & 1
    return out.reshape(*bad.shape[:-1], bad.shape[-1] * MASK_BITS_PER_WORD)


def extract_kmers(packed: torch.Tensor, bad: torch.Tensor,
                  length: torch.Tensor, k: int) -> KmerBatch:
    """Canonical (hi, lo) k-mers at every position of every read.

    Output tensors have shape (R, m) with m = 16*W - k + 1; `valid` masks
    positions past the true read length or covering an ambiguous base.
    Bit-exact with ``hga_tpu.ops.kmer.extract_kmers``.
    """
    if not (1 <= k <= 32):
        raise ValueError("k must be in [1, 32]")
    bases = unpack_bases(packed)          # (R, L) int64
    R, L = bases.shape
    m = L - k + 1
    if m <= 0:
        raise ValueError(f"pad length {L} shorter than k={k}")
    dev = bases.device
    fwd_hi = torch.zeros((R, m), dtype=torch.int64, device=dev)
    fwd_lo = torch.zeros_like(fwd_hi)
    rc_hi = torch.zeros_like(fwd_hi)
    rc_lo = torch.zeros_like(fwd_hi)
    for t in range(k):
        b = bases[:, t:t + m]
        sh = 2 * (k - 1 - t)              # shift of base t in the fwd value
        if sh >= 32:
            fwd_hi |= b << (sh - 32)
        else:
            fwd_lo |= b << sh
        c = 3 - b
        shr = 2 * t                       # shift of base t in the rc value
        if shr >= 32:
            rc_hi |= c << (shr - 32)
        else:
            rc_lo |= c << shr
    fwd_lo &= M32
    rc_lo &= M32
    fwd_le = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    hi = torch.where(fwd_le, fwd_hi, rc_hi)
    lo = torch.where(fwd_le, fwd_lo, rc_lo)
    strand = (~fwd_le).to(torch.uint8)

    pos = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    in_range = pos + k <= length.to(torch.int64)[:, None]
    badbits = unpack_badmask(bad)[:, :L]
    badcum = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                        torch.cumsum(badbits, dim=1)], dim=1)   # (R, L+1)
    window_bad = badcum[:, k:k + m] - badcum[:, :m]
    valid = in_range & (window_bad == 0)
    return KmerBatch(hi=hi, lo=lo, strand=strand, valid=valid)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for 0 <= a, c < 2^32, in int64 without overflow."""
    lo16 = a * (c & 0xFFFF)
    hi16 = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo16 + hi16) & M32


def kmer_hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of (lo ^ hi*golden), int64 holding uint32 values."""
    x = lo ^ _mul32(hi, 0x9E3779B1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x
