"""L3 — bit-parallel Myers semi-global edit distance, plain PyTorch version.

Counterpart of ``hga_tpu.ops.myers`` and the plain version of the two CUDA
kernels in ops/myers_cuda.py: the CPU path of the port, and the yardstick
each kernel is held against on the card.

Semantics (utils/oracle.edit_distance_hw): infix / "HW" mode — the query
aligns fully, target start and end are free: D[i][0] = i, D[0][j] = 0, the
result is min_j D[m][j] with the smallest such j (1-based end in the target).

Word layout as in the reference: 31 payload bits per word, bit 31 catches the
adder and shifter carries, W = ceil(Lq/31) words per pair; planes and query
bit-planes are int32 and compare word for word with the JAX package.  The
recurrence runs in int64 so that the carry-producing sum never overflows;
every word that leaves a column is masked back to its 31 payload bits.

    Eq = VQ & ~((Q0 ^ T0) | (Q1 ^ T1)) & TV
    Xv = Eq | Mv
    s  = (Eq & Pv) + Pv + carry_in          # carry chains through bit 31
    Xh = (s ^ Pv) | Eq
    Ph = Mv | ~(Xh | Pv)
    Mh = Pv & Xh
    score += bottom-bit(Ph) - bottom-bit(Mh)
    Ph, Mh <<= 1                            # cross-word via bit 30
    Pv' = (Mh | ~(Xv | Ph)) & M31
    Mv' = Ph & Xv
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PAYLOAD = 31
M31 = (1 << 31) - 1          # payload mask (bit 31 clear)
MAX_WORDS = 24               # the CUDA kernels' unrolled word capacity
MAX_QUERY_LEN = MAX_WORDS * PAYLOAD


class MyersResult(NamedTuple):
    dist: torch.Tensor   # int32 (N,) min semi-global edit distance
    tend: torch.Tensor   # int32 (N,) end position in target (1-based, 0 if m=0)


def n_words(Lq: int) -> int:
    return max(1, -(-Lq // PAYLOAD))


def query_planes(q: torch.Tensor, qlen: torch.Tensor, W: int):
    """Bit-planes of the query: Q0/Q1 (low/high base bit) and VQ (validity),
    plus the end-bit mask mend with the single bit (qlen-1) set.

    q: (N, Lq) base codes; codes >= 4 and positions >= qlen are invalid.
    Returns four int32 (N, W) tensors (bit b of word w = query
    position w*31+b).
    """
    N, Lq = q.shape
    dev = q.device
    qp = torch.full((N, W * PAYLOAD), 4, dtype=torch.int64, device=dev)
    qp[:, :Lq] = q.to(torch.int64)
    pos = torch.arange(W * PAYLOAD, dtype=torch.int64, device=dev)[None, :]
    ql = qlen.to(torch.int64)[:, None]
    valid = ((pos < ql) & (qp < 4)).to(torch.int64)
    shifts = (torch.arange(PAYLOAD, dtype=torch.int64, device=dev))

    def plane(bits):
        return (bits.reshape(N, W, PAYLOAD) << shifts).sum(dim=2).to(
            torch.int32)

    q0 = plane((qp & 1) * valid)
    q1 = plane(((qp >> 1) & 1) * valid)
    vq = plane(valid)
    end_bit = torch.clamp(ql - 1, min=0)
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    mend = torch.where((end_bit // PAYLOAD == w_idx) & (ql > 0),
                       1 << (end_bit % PAYLOAD), 0).to(torch.int32)
    return q0, q1, vq, mend


def _columns(qp, t, qlen, tlen, planes: bool):
    """Run the column recurrence over every target column, from the
    query's (q0, q1, vq, mend) bit-planes (int32 (N, W), query_planes).

    Returns (best, bj) and, with planes=True, the int32 (Lt, N, W) Pv/Mv
    planes stored after every column.
    """
    q0, q1, vq, mend = (x.to(torch.int64) for x in qp)
    N, W = q0.shape
    Lt = t.shape[1]
    dev = t.device
    pv = torch.full((N, W), M31, dtype=torch.int64, device=dev)
    mv = torch.zeros((N, W), dtype=torch.int64, device=dev)
    ql = qlen.to(torch.int64)
    tl = tlen.to(torch.int64)
    score = ql.clone()
    best = ql.clone()
    bj = torch.zeros(N, dtype=torch.int64, device=dev)
    tt = t.to(torch.int64)
    zero = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    pvp = mvp = None
    if planes:
        pvp = torch.empty((Lt, N, W), dtype=torch.int32, device=dev)
        mvp = torch.empty((Lt, N, W), dtype=torch.int32, device=dev)
    for j in range(Lt):
        tc = tt[:, j:j + 1]
        t0 = -(tc & 1)
        t1 = -((tc >> 1) & 1)
        # full compare: any code outside 0..3 (sentinels, negative pads,
        # aliases >= 8) never matches
        tvm = -((tc >= 0) & (tc < 4)).to(torch.int64)
        eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
        xv = eq | mv
        a = eq & pv
        s = torch.empty_like(pv)
        c = zero
        for w in range(W):
            sw = a[:, w:w + 1] + pv[:, w:w + 1] + c
            c = (sw >> 31) & 1
            s[:, w:w + 1] = sw & M31
        xh = (s ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        pbit = ((ph & mend) != 0).any(dim=1).to(torch.int64)
        mbit = ((mh & mend) != 0).any(dim=1).to(torch.int64)
        score = score + pbit - mbit
        # cross-word left shift via bit 30
        cp = torch.cat([zero, (ph[:, :-1] >> 30) & 1], dim=1)
        cm = torch.cat([zero, (mh[:, :-1] >> 30) & 1], dim=1)
        ph = ((ph << 1) & M31) | cp
        mh = ((mh << 1) & M31) | cm
        pv = (mh | ~(xv | ph)) & M31
        mv = ph & xv
        if planes:
            pvp[j] = pv.to(torch.int32)
            mvp[j] = mv.to(torch.int32)
        take = (score < best) & (j < tl)
        bj = torch.where(take, j + 1, bj)
        best = torch.where(take, score, best)
    zero_q = ql == 0
    res = MyersResult(dist=torch.where(zero_q, 0, best).to(torch.int32),
                      tend=torch.where(zero_q, 0, bj).to(torch.int32))
    return res, pvp, mvp


def myers_batch(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                tlen: torch.Tensor, W: int = 0) -> MyersResult:
    """Batched bit-parallel semi-global edit distance (plain PyTorch).

    q, t: base codes (N, Lq), (N, Lt); codes outside 0..3 never match.
    """
    W = W or n_words(q.shape[1])
    res, _, _ = _columns(query_planes(q, qlen, W), t, qlen, tlen, False)
    return res


def myers_batch_from_planes(q0: torch.Tensor, q1: torch.Tensor,
                            vq: torch.Tensor, mend: torch.Tensor,
                            t: torch.Tensor, qlen: torch.Tensor,
                            tlen: torch.Tensor) -> MyersResult:
    """myers_batch from precomputed query bit-planes (query_planes, int32
    (N, W) each): the plain version of the slab harness kernel X1."""
    res, _, _ = _columns((q0, q1, vq, mend), t, qlen, tlen, False)
    return res


def myers_batch_planes(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                       tlen: torch.Tensor, W: int = 0):
    """myers_batch + per-column Pv/Mv planes: (MyersResult, pv, mv) with
    planes int32 (Lt, N, W); planes[c] is the state AFTER target column c."""
    W = W or n_words(q.shape[1])
    return _columns(query_planes(q, qlen, W), t, qlen, tlen, True)
