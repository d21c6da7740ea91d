"""L3 — banded local Smith-Waterman, score and end cell (plain PyTorch).

Counterpart of ``hga_tpu.ops.align`` (``banded_sw_batch``, ``sw_cells``) and
the plain version of the CUDA kernel K3 in ops/align_cuda.py: the kernel's
wrapper runs this function for CPU tensors, and chip_smoke.py holds the
kernel to it on the card.

Semantics (``hga_tpu.ops.align.banded_sw_batch`` exactly): cells (i, j) with
1 <= i <= min(qlen, Lq), 1 <= j <= min(tlen, Lt) and |j - i| <= band;
H = max(0, H[i-1][j-1] + (match if q[i-1] == t[j-1] else mismatch),
H[i-1][j] + gap, H[i][j-1] + gap) with H = 0 on row and column 0.  Codes
compare as integers: the padding codes 4 and -1 match only themselves.  The
best cell is the highest H, then the smallest anti-diagonal d = i + j, then
the smallest i; score = max(best, 0), qend/tend 1-based, all three 0 when no
cell is positive.

This version sweeps anti-diagonals over the full query axis (slot p holds
cell (p + 1, d - p - 1)) and stores 0 in cells outside the band or the
lengths.  The reference stores -inf there instead; both give the same
scores because every stored value is >= 0 and gap <= 0, so a leaked 0 can
never beat the cell's own candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SWResult(NamedTuple):
    score: torch.Tensor  # int32 (P,) best local score (0 if none positive)
    qend: torch.Tensor   # int32 (P,) query end, 1-based inclusive (0 if none)
    tend: torch.Tensor   # int32 (P,) target end, 1-based inclusive


def check_scores(band: int, gap: int) -> None:
    if band < 0:
        raise ValueError(f"band must be >= 0, got {band}")
    if gap > 0:
        raise ValueError(f"the linear gap score must be <= 0, got {gap}")


def banded_sw_batch(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                    tlen: torch.Tensor, band: int = 64, match: int = 2,
                    mismatch: int = -4, gap: int = -3) -> SWResult:
    """Batched banded local SW: q (P, Lq), t (P, Lt) integer codes, lengths
    (P,); returns int32 score, qend, tend."""
    check_scores(band, gap)
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    zeros = torch.zeros(P, dtype=i32, device=dev)
    if P == 0 or Lq == 0 or Lt == 0:
        return SWResult(zeros, zeros.clone(), zeros.clone())
    q = q.to(i32)
    i = torch.arange(1, Lq + 1, dtype=i32, device=dev)[None, :]
    ql = qlen.to(i32)[:, None]
    tl = torch.clamp(tlen.to(i32), max=Lt)[:, None]
    # cell (i, d - i) is inside the band and the lengths iff dlo <= d <= dhi
    dlo = i + torch.clamp(i - band, min=1)
    dhi = torch.where(i <= ql, i + torch.minimum(tl, i + band), -1)
    # reversed target padded by Lq each side: step d reads t[d - p - 2] at
    # slot p as the contiguous slice t_ext[:, Lq + Lt + 1 - d : ... + Lq]
    t_ext = torch.full((P, Lt + 2 * Lq), -1, dtype=i32, device=dev)
    t_ext[:, Lq:Lq + Lt] = torch.flip(t.to(i32), dims=(1,))
    mt = torch.tensor(match, dtype=i32, device=dev)
    mm = torch.tensor(mismatch, dtype=i32, device=dev)
    zcol = torch.zeros((P, 1), dtype=i32, device=dev)
    ad1 = torch.zeros((P, Lq), dtype=i32, device=dev)  # v on d - 1
    s2 = ad1                                          # shifted v on d - 2
    best, best_d, best_p = zeros, zeros, zeros
    for d in range(2, Lq + Lt + 1):
        base = Lq + Lt + 1 - d
        sub = torch.where(q == t_ext[:, base:base + Lq], mt, mm)
        s1 = torch.cat([zcol, ad1[:, :-1]], dim=1)     # up neighbours
        v = torch.maximum(torch.clamp(s2 + sub, min=0),
                          torch.maximum(ad1, s1) + gap)
        v = torch.where((dlo <= d) & (d <= dhi), v, 0)
        pm = torch.argmax(v, dim=1)                     # first max: min i
        m = torch.gather(v, 1, pm[:, None])[:, 0]
        better = m > best                               # strict: min d
        best = torch.where(better, m, best)
        best_d = torch.where(better, d, best_d)
        best_p = torch.where(better, pm.to(i32), best_p)
        s2, ad1 = s1, v
    has = best > 0
    qend = torch.where(has, best_p + 1, 0)
    tend = torch.where(has, best_d - qend, 0)
    return SWResult(score=torch.clamp(best, min=0), qend=qend, tend=tend)


def sw_cells(qlen, tlen, band: int) -> int:
    """Number of in-band DP cells actually defined (for GCUPS accounting)."""
    qlen = np.asarray(qlen, np.int64).ravel()
    tlen = np.asarray(tlen, np.int64).ravel()
    if qlen.size == 0:
        return 0
    i = np.arange(1, int(qlen.max(initial=0)) + 1)[None, :]
    lo = np.maximum(1, i - band)
    hi = np.minimum(tlen[:, None], i + band)
    n = np.maximum(0, hi - lo + 1) * (i <= qlen[:, None])
    return int(n.sum())
