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

``banded_sw_batch_dirs`` (the scored-SW correction engine,
corr_engine="sw") is a copy of the reference's band-slot wavefront, which
also records a traceback direction per cell: plain XLA there, plain
PyTorch here (no kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


# the reference's -inf of the band-slot wavefront (banded_sw_batch_dirs)
NEG = -(2**30)


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


def _o_of(d: int, band: int, Lt: int) -> int:
    """Lower i bound of the band on anti-diagonal d (the reference's
    ``_o_of``; Python's // floors, as jnp's does)."""
    return max(1, d - Lt, (d - band + 1) // 2)


def banded_sw_batch_dirs(q: torch.Tensor, t: torch.Tensor,
                         qlen: torch.Tensor, tlen: torch.Tensor,
                         band: int = 64, match: int = 2, mismatch: int = -4,
                         gap: int = -3) -> Tuple[SWResult, torch.Tensor]:
    """Wavefront SW that also records each cell's traceback direction
    (``hga_tpu.ops.align.banded_sw_batch_dirs`` exactly).

    Slot p of anti-diagonal d holds cell (i, j) = (o(d) + p, d - i), o(d) =
    max(1, d - Lt, ceil((d - band) / 2)), over a band vector padded to W =
    round up of band + 1 to 128.  Returns (SWResult, dirs) with dirs int8
    (D, P, W), D = Lq + Lt - 1 (index d - 2); 0 = stop (local start or
    outside), 1 = diagonal, 2 = up (gap in target), 3 = left (gap in
    query), preferred in the order diag > up > left.  The best cell is the
    highest H, then the smallest d, then the smallest slot.

    Only slots p <= band can hold a cell (i_hi(d) - o(d) <= band), so the
    sweep runs band + 1 slots and the slots past them stay -inf (NEG) and
    stop (0), as they are in the reference.  The sweep keeps slots in rows
    and pairs in columns, so every shifted or clamped window of the
    reference is a contiguous block of rows; the anti-diagonals live in
    NEG-padded blocks (two slots each side), and the zero row and column
    (H = 0 at i = 0 or j = 0) touch one slot a step each.
    """
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    W = ((band + 1 + 127) // 128) * 128
    S = band + 1                       # the slots that can hold a cell
    D = max(0, Lq + Lt - 1)
    zeros = torch.zeros(P, dtype=i32, device=dev)
    if P == 0 or D == 0:
        return (SWResult(zeros, zeros.clone(), zeros.clone()),
                torch.zeros((D, P, W), dtype=torch.int8, device=dev))
    dirs_t = torch.zeros((D, W, P), dtype=torch.int8, device=dev)
    # codes slot-major: row r of q_t is query position r (pairs across)
    q_t = torch.nn.functional.pad(q.to(i32), (0, W)).T.contiguous()
    t_t = torch.nn.functional.pad(torch.flip(t.to(i32), dims=(1,)),
                                  (0, W)).T.contiguous()
    slot = torch.arange(S, dtype=i32, device=dev)[:, None]
    # a step's cells as one key, H * S + (S - 1 - p): its maximum is the
    # highest H at the smallest slot (H <= 0 clamps to -1 and never wins)
    kdt = i32 if (max(match, 0) * min(Lq, Lt) + 2) * S < 2**31 \
        else torch.int64
    rslot = (S - 1 - slot).to(kdt)
    ql = qlen.to(i32)[None, :]
    tl = tlen.to(i32)[None, :]
    mt = torch.tensor(match, dtype=i32, device=dev)
    mm = torch.tensor(mismatch, dtype=i32, device=dev)
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    one = torch.tensor(1, dtype=torch.int8, device=dev)
    stop = torch.tensor(0, dtype=torch.int8, device=dev)
    rows = [torch.full((S + 4, P), NEG, dtype=i32, device=dev)
            for _ in range(3)]                      # d - 2, d - 1, d
    best, best_d, best_p = zeros, zeros, zeros
    for d in range(2, Lq + Lt + 1):
        o_d = _o_of(d, band, Lt)
        d1 = o_d - _o_of(d - 1, band, Lt)
        d2 = o_d - _o_of(d - 2, band, Lt)
        # the reference's dynamic_slice clamps the query window's start
        # into range; a clamped window holds only cells past Lq (masked)
        qs0 = min(o_d - 1, Lq)
        ts0 = Lt - d + o_d
        sub = torch.where(q_t[qs0:qs0 + S] == t_t[ts0:ts0 + S], mt, mm)
        e2, e1, e0 = rows
        cand_diag = e2[1 + d2:1 + d2 + S] + sub
        cand_up = e1[1 + d1:1 + d1 + S] + gap
        cand_left = e1[2 + d1:2 + d1 + S] + gap
        if o_d == 1:                                # i == 1 at slot 0
            cand_diag[0] = sub[0]
            cand_up[0] = gap
        pj = d - o_d - 1                            # j == 1 at slot pj
        if 0 <= pj < S:
            cand_diag[pj] = sub[pj]
            cand_left[pj] = gap
        v = torch.maximum(torch.clamp(cand_diag, min=0),
                          torch.maximum(cand_up, cand_left))
        # valid slots: p <= i_hi(d) - o_d, o_d + p <= qlen, 1 <= j <= tlen
        i_hi = min(Lq, d - 1, (d + band) // 2)
        hi = torch.clamp(ql - o_d, max=min(i_hi - o_d, d - o_d - 1))
        lo = torch.clamp(d - o_d - tl, min=0)
        valid = (slot >= lo) & (slot <= hi)
        # diag > up > left; stop where H is 0 or outside
        dr = torch.where(v == cand_diag, one,
                         3 - (v == cand_up).to(torch.int8))
        torch.where(valid & (v != 0), dr, stop, out=dirs_t[d - 2, :S])
        vv = e0[2:2 + S]
        torch.where(valid, v, neg, out=vv)
        key = torch.add(rslot, torch.clamp(vv, min=-1).to(kdt), alpha=S)
        kmax = key.max(dim=0).values
        m = torch.div(kmax, S, rounding_mode="floor")
        better = m > best
        best = torch.where(better, m.to(i32), best)
        best_d = torch.where(better, d, best_d)
        best_p = torch.where(better, (S - 1 - (kmax - m * S)).to(i32),
                             best_p)
        rows = [e1, e0, e2]
    has = best > 0
    o_best = torch.maximum(torch.clamp(best_d - Lt, min=1),
                           torch.div(best_d - band + 1, 2,
                                     rounding_mode="floor"))
    qend = torch.where(has, o_best + best_p, 0)
    tend = torch.where(has, best_d - qend, 0)
    return (SWResult(score=torch.clamp(best, min=0), qend=qend, tend=tend),
            dirs_t.permute(0, 2, 1).contiguous())


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
