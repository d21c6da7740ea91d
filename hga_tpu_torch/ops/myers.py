"""L3 — bit-parallel Myers semi-global edit distance, plain PyTorch version.

Counterpart of ``hga_tpu.ops.myers`` and the plain version of the CUDA
kernels in ops/myers_cuda.py (``myers_cols`` that of K1''s carried-state
mode): the CPU path of the port, and the yardstick each kernel is held
against on the card, at any number of query words.  ``myers_cols_windowed``
splits the target's columns into windows as K1' does on the card (a fresh
DP a halo before each window, a lexicographic reduction of the windows'
bests); only the tests call it: it shows on the CPU that the windows equal
the one sweep.

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
INT32_MAX = (1 << 31) - 1    # a window's best before its first owned column


class MyersResult(NamedTuple):
    dist: torch.Tensor   # int32 (N,) min semi-global edit distance
    tend: torch.Tensor   # int32 (N,) end position in target (1-based, 0 if m=0)


def n_words(Lq: int) -> int:
    return max(1, -(-Lq // PAYLOAD))


def window_halo(W: int) -> int:
    """Columns a target window k >= 1 runs before its own: 2 x 31 x W.  An
    optimal semi-global alignment of a query row i <= 31 W ending at column
    j starts at or after column j - 2 i (D[i][j] <= i, and a span of L
    columns costs at least L - i), so a fresh DP started that far back
    reproduces every D[i][j] of the window's columns."""
    return 2 * PAYLOAD * W


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


def myers_init_state(qlen: torch.Tensor, W: int):
    """Fresh column-0 state (pv, mv, score, best, bj), int32, for a query
    batch: pv all ones (31 bits), mv 0, score = best = qlen, bj 0."""
    N = qlen.shape[0]
    dev = qlen.device
    ql = qlen.to(torch.int32)
    return (torch.full((N, W), M31, dtype=torch.int32, device=dev),
            torch.zeros((N, W), dtype=torch.int32, device=dev),
            ql.clone(), ql.clone(),
            torch.zeros(N, dtype=torch.int32, device=dev))


def pack_state(state) -> torch.Tensor:
    """A state tuple as one int32 (N, 2 W + 3) tensor: pv, mv, score, best,
    bj side by side (K1''s carried-state rows, the ring's message)."""
    pv, mv, *rest = state
    return torch.cat([pv.to(torch.int32), mv.to(torch.int32)]
                     + [x.to(torch.int32)[:, None] for x in rest], dim=1)


def unpack_state(st: torch.Tensor, W: int):
    """pack_state's inverse (views of `st`)."""
    return (st[:, :W], st[:, W:2 * W], st[:, 2 * W], st[:, 2 * W + 1],
            st[:, 2 * W + 2])


def myers_cols(q0, q1, vq, mend, t, tlen, state, j0: int = 0):
    """Advance the Myers recurrence over the target columns in `t` (N, Lt)
    or one shared row (1, Lt), from the query bit-planes (query_planes).

    state: (pv, mv, score, best, bj) from myers_init_state or a previous
    call; j0 is the GLOBAL index of t's first column (the tlen mask and the
    tend values stay global).  Returns the state after t's last column:
    what the ring engine (parallel/ring_myers.py) hands from rank to rank,
    and the plain version of K1''s carried-state mode.
    """
    state, _, _ = _cols((q0, q1, vq, mend), t, tlen, state, j0, False)
    return state


def _cols(qp, t, tlen, state, j0: int, planes: bool):
    """The column recurrence; with planes=True also the int32 (Lt, N, W)
    Pv/Mv planes stored after every column."""
    q0, q1, vq, mend = (x.to(torch.int64) for x in qp)
    N, W = q0.shape
    Lt = t.shape[1]
    dev = t.device
    pv, mv, score, best, bj = (x.to(torch.int64) for x in state)
    tl = tlen.to(torch.int64)
    tt = t.to(torch.int64)
    zero = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    col = torch.arange(W, dtype=torch.int64, device=dev).expand(N, W)
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
        # the W-word sum (eq & pv) + pv with carries through bit 31: the
        # carry into word w is the carry out of the last word below it that
        # does not pass a carry on (its 31 bits not all ones), 0 if none
        sw = (eq & pv) + pv
        gen = sw >> 31
        stop = torch.where((sw & M31) == M31, -1, col)
        last = torch.cummax(stop, dim=1).values[:, :-1]
        c = torch.where(last >= 0, gen.gather(1, last.clamp(min=0)), 0)
        s = (sw + torch.cat([zero, c], dim=1)) & M31
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
        jg = j0 + j
        take = (score < best) & (jg < tl)
        bj = torch.where(take, jg + 1, bj)
        best = torch.where(take, score, best)
    out = tuple(x.to(torch.int32) for x in (pv, mv, score, best, bj))
    return out, pvp, mvp


def myers_cols_windowed(q0, q1, vq, mend, t, qlen, tlen, state,
                        j0: int = 0, window: int = 0):
    """myers_cols over target windows of `window` owned columns, as K1'
    runs them on the card (csrc/myers_gate.cu): window 0 runs from `state`;
    window k >= 1 owns columns [k window, (k + 1) window) and runs a fresh
    DP (myers_init_state, best INT32_MAX) from window_halo(W) columns
    before them, counting no column of that halo; the result is the last
    window's pv, mv and score with the lexicographically least (best, bj)
    over the windows.  Equal to myers_cols bit for bit (window_halo's span
    bound); `window` must be at least the halo where it splits the target
    (0: one window)."""
    W, Lt = q0.shape[1], t.shape[1]
    H = window_halo(W)
    if window <= 0 or window >= Lt:
        return myers_cols(q0, q1, vq, mend, t, tlen, state, j0)
    if window < H:
        raise ValueError(f"a window of {window} columns is shorter than its "
                         f"halo ({H} at W={W})")
    qp, none = (q0, q1, vq, mend), torch.zeros_like(tlen)
    out = myers_cols(*qp, t[:, :window], tlen, state, j0)
    best, bj = out[3], out[4]
    for c in range(window, Lt, window):
        st = myers_init_state(qlen, W)
        st = st[:3] + (torch.full_like(st[3], INT32_MAX), st[4])
        st = myers_cols(*qp, t[:, c - H:c], none, st, j0 + c - H)
        out = myers_cols(*qp, t[:, c:c + window], tlen, st, j0 + c)
        take = (out[3] < best) | ((out[3] == best) & (out[4] < bj))
        best = torch.where(take, out[3], best)
        bj = torch.where(take, out[4], bj)
    return out[:3] + (best, bj)


def state_result(qlen: torch.Tensor, state) -> MyersResult:
    """(dist, tend) of a finished state: best and bj, 0 where qlen = 0."""
    zero_q = qlen == 0
    best, bj = state[3], state[4]
    return MyersResult(dist=torch.where(zero_q, 0, best).to(torch.int32),
                       tend=torch.where(zero_q, 0, bj).to(torch.int32))


def _columns(qp, t, qlen, tlen, planes: bool):
    """Run the recurrence over every target column from a fresh state.
    Returns (MyersResult, pv planes, mv planes); planes None unless asked."""
    state = myers_init_state(qlen, qp[0].shape[1])
    state, pvp, mvp = _cols(qp, t, tlen, state, 0, planes)
    return state_result(qlen, state), pvp, mvp


def myers_batch(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                tlen: torch.Tensor, W: int = 0) -> MyersResult:
    """Batched bit-parallel semi-global edit distance (plain PyTorch).

    q, t: base codes (N, Lq), and (N, Lt) or one row (1, Lt) that every
    pair runs against (each column broadcasts); codes outside 0..3 never
    match.
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
