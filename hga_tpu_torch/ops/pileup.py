"""L5 device ops — plane-based traceback, vote scatter, consensus (PyTorch).

Counterpart of the Myers half of ``hga_tpu.ops.pileup``.  The pileup is a
flat vote buffer — column votes (backbone x column x N_SYM) then insertion
votes (backbone x column x slot x base) — filled by an int32 scatter-add over
every alignment move; a scatter-add of integers gives the same votes in any
order, so GPU atomics keep the result exact.

The buffer carries ONE sink slot past the logical votes: moves the reference
drops with ``mode="drop"`` (index == size_all) land in the sink, and callers
cut it off.

Symbols: 0..3 = A,C,G,T (substitution vote), 4 = deletion, 5 = unused slot.

``myers_votes`` is one correction batch end to end (planes DP, float32
identity gate, traceback, votes): the plain version of the CUDA kernel K2'
(ops/myers_cuda.myers_votes_cuda), which does the same in one launch.

``traceback_columns`` and ``accumulate_backbone_votes_merged`` walk the
direction codes of ops/align.banded_sw_batch_dirs (the scored-SW engine,
corr_engine="sw"): copies of the reference's functions of those names,
plain XLA there and plain PyTorch here; ``accumulate_backbone_votes`` is
its two-buffer convenience, and ``consensus_votes`` a scatter of single
votes into (length, N_SYM), as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hga_tpu_torch.ops.myers import MyersResult, myers_batch_planes

N_SYM = 6


def consensus_votes(cols: torch.Tensor, syms: torch.Tensor,
                    valid: torch.Tensor, length: int) -> torch.Tensor:
    """Scatter votes into an int32 (length, N_SYM) tensor
    (``hga_tpu.ops.pileup.consensus_votes``): cols int32 (N,) backbone
    columns, syms (N,) symbols (clipped to 0..N_SYM - 1), valid bool (N,).
    Invalid rows are sent past the end and dropped; as in the reference's
    scatter, a flat index in [-size, 0) counts from the end and any other
    index outside [0, size) is dropped (size = length * N_SYM)."""
    size = length * N_SYM
    flat = (torch.where(valid, cols.to(torch.int64), length) * N_SYM
            + torch.clamp(syms.to(torch.int64), 0, N_SYM - 1))
    flat = torch.where(flat < 0, flat + size, flat)
    keep = (flat >= 0) & (flat < size)
    votes = torch.zeros(size, dtype=torch.int32, device=cols.device)
    votes.index_add_(0, flat[keep], valid[keep].to(torch.int32))
    return votes.reshape(length, N_SYM)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values below 2^32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _plane_prefix(pv: torch.Tensor, mv: torch.Tensor,
                  i: torch.Tensor) -> torch.Tensor:
    """D(i, col) from that column's Pv/Mv words (P, W): prefix sum of the
    vertical deltas over bits 0..i-1 (semi-global: D(0, col) = 0)."""
    W = pv.shape[1]
    w31 = 31 * torch.arange(W, dtype=torch.int64, device=pv.device)[None, :]
    mask = (1 << torch.clamp(i[:, None] - w31, 0, 31)) - 1
    return (_popcount(pv.to(torch.int64) & mask)
            - _popcount(mv.to(torch.int64) & mask)).sum(dim=1)


def _plane_bit(pv: torch.Tensor, mv: torch.Tensor,
               i: torch.Tensor) -> torch.Tensor:
    """Vertical delta at row i of a column's planes: +1/-1/0 (bit i-1)."""
    W = pv.shape[1]
    wi = torch.div(i - 1, 31, rounding_mode="floor")
    bi = torch.remainder(i - 1, 31)
    sel = torch.clamp(wi, 0, W - 1)[:, None]
    pb = (torch.gather(pv, 1, sel)[:, 0].to(torch.int64) >> bi) & 1
    mb = (torch.gather(mv, 1, sel)[:, 0].to(torch.int64) >> bi) & 1
    return torch.where((wi >= 0) & (wi < W), pb - mb, 0)


def accumulate_backbone_votes_myers(
    merged: torch.Tensor,     # int32 (size_all + 1,) flat votes + sink slot
    pv_planes: torch.Tensor,  # int32 (Lt, P, W) from the Myers planes DP
    mv_planes: torch.Tensor,  # int32 (Lt, P, W)
    dist: torch.Tensor,       # int32 (P,) semi-global edit distance
    qend: torch.Tensor,       # int32 (P,) = qlen, pre-masked 0 by the gate
    tend: torch.Tensor,       # int32 (P,) end column (1-based)
    q: torch.Tensor,          # int32 (P, Lq) oriented query codes
    t: torch.Tensor,          # int32 (P, Lt) backbone window codes
    bb: torch.Tensor,         # int32 (P,) backbone id per pair
    off: torch.Tensor,        # int32 (P,) window col -> forward backbone col
    lb: torch.Tensor,         # int32 (P,) backbone true length per pair
    qw: Optional[torch.Tensor] = None,  # int32 (P, Lq) per-base vote weights
    *,
    size_v: int,
    lpad: int,
    ins_slots: int = 3,
    max_steps: Optional[int] = None,
) -> torch.Tensor:
    """Plane-based lockstep traceback + vote scatter, updating `merged` in
    place (and returning it).

    Same walk as ``hga_tpu.ops.pileup.accumulate_backbone_votes_myers``:
    moves are re-derived from the Pv/Mv planes (left/diag neighbours are
    plane prefix sums of column j-1, the up neighbour is D minus the
    vertical delta bit of column j), precedence diag > up > left, stop at
    i == 0.  The scan is a Python loop of at most min(Lq + Lt, max_steps)
    steps over all P pairs at once; it stops early once no pair is active
    (the remaining steps of the reference emit only dropped votes).
    """
    Lt, P, W = pv_planes.shape
    Lq = q.shape[1]
    S = Lq + Lt
    if max_steps is not None:
        S = min(S, max_steps)
    size_all = merged.shape[0] - 1
    dev = q.device
    i64 = lambda x: x.to(torch.int64)
    pid = torch.arange(P, dtype=torch.int64, device=dev)
    bb, off, lb = i64(bb), i64(off), i64(lb)
    base_v = bb * (lpad * N_SYM)
    base_i = bb * (lpad * ins_slots * 4) + size_v
    i, j, D = i64(qend), i64(tend), i64(dist)
    run = torch.zeros(P, dtype=torch.int64, device=dev)
    active = qend > 0
    idx_parts, w_parts = [], []
    for step in range(S):
        if step % 32 == 0 and not bool(active.any()):
            break
        jm1 = torch.clamp(j - 1, 0, Lt - 1)
        jm2 = torch.clamp(j - 2, 0, Lt - 1)
        pv1, mv1 = pv_planes[jm1, pid], mv_planes[jm1, pid]
        pv2, mv2 = pv_planes[jm2, pid], mv_planes[jm2, pid]
        # up neighbour: D(i-1, j) = D - deltaV(i, j); column 0 has D(i,0)=i
        dv_j = torch.where(j >= 1, _plane_bit(pv1, mv1, i), 1)
        # left/diag neighbours need column j-1's cell values
        dl = torch.where(j >= 2, _plane_prefix(pv2, mv2, i), i)  # D(i,j-1)
        dv_jm1 = torch.where(j >= 2, _plane_bit(pv2, mv2, i), 1)
        dd = dl - dv_jm1                                         # D(i-1,j-1)
        qi = torch.clamp(i - 1, 0, Lq - 1)
        qsym = i64(q[pid, qi])
        tsym = i64(t[pid, jm1])
        sub = ((qsym != tsym) | (qsym >= 4) | (tsym >= 4)).to(torch.int64)
        diag = active & (j >= 1) & (dd + sub == D)
        up = active & (dv_j == 1) & ~diag
        left = active & (j >= 1) & (dl + 1 == D) & ~diag & ~up
        colf = (j - 1) + off
        in_rng = (colf >= 0) & (colf < lb)
        sym = torch.where(diag, qsym, 4)
        idx_v = torch.where((diag | left) & in_rng,
                            base_v + colf * N_SYM + sym, size_all)
        # j >= 1: read bases left at the free target prefix align BEFORE
        # the window and are not insertions
        idx_i = torch.where(
            up & in_rng & (run < ins_slots) & (j >= 1),
            base_i + (colf * ins_slots + torch.clamp(run, 0, ins_slots - 1))
            * 4 + torch.clamp(qsym, 0, 3), size_all)
        idx_parts += [idx_v, idx_i]
        if qw is not None:
            wq = qw[pid, qi]
            w_parts += [wq, wq]
        run = torch.where(up, run + 1, 0)
        D = D - torch.where(diag, sub, (up | left).to(torch.int64))
        i = i - (diag | up).to(torch.int64)
        j = j - (diag | left).to(torch.int64)
        active = active & (diag | up | left) & (i >= 1)
    if idx_parts:
        idx = torch.cat(idx_parts)
        w = (torch.ones(idx.shape[0], dtype=merged.dtype, device=dev)
             if qw is None else torch.cat(w_parts).to(merged.dtype))
        merged.index_add_(0, idx, w)
    return merged


def _dirs_walk(dirs: torch.Tensor, qend: torch.Tensor, tend: torch.Tensor,
               q: torch.Tensor, band: int, Lt: int, stop_early: bool):
    """The lockstep walk of the reference's dirs traceback: from (qend,
    tend), every active pair follows its cell's direction code each step;
    stops where the code is 0 or a row or column reaches 0.  Yields per
    step (i, j, run, qsym, diag, up, left) before the move, int64 (P,)
    and bool (P,), for the reference's S = Lq + Lt steps, or with
    stop_early until every pair stopped (a stopped pair makes no move).
    An empty dirs or query (D or Lq 0) reads as all-stop."""
    D, P, W = dirs.shape
    Lq = q.shape[1]
    dev = q.device
    pid = torch.arange(P, dtype=torch.int64, device=dev)
    i, j = qend.to(torch.int64), tend.to(torch.int64)
    run = torch.zeros(P, dtype=torch.int64, device=dev)
    active = qend > 0
    for step in range(Lq + Lt):
        if stop_early and step % 32 == 0 and not bool(active.any()):
            return
        d = i + j
        o_d = torch.maximum(torch.clamp(d - Lt, min=1),
                            torch.div(d - band + 1, 2, rounding_mode="floor"))
        p = i - o_d
        ok = active & (p >= 0) & (p < W) & (d >= 2)
        if D and Lq:
            code = dirs[torch.clamp(d - 2, 0, D - 1), pid,
                        torch.clamp(p, 0, W - 1)].to(torch.int64)
            dir_ = torch.where(ok, code, 0)
            qsym = q[pid, torch.clamp(i - 1, 0, Lq - 1)].to(torch.int64)
        else:
            dir_ = torch.zeros_like(i)
            qsym = torch.zeros_like(i)
        diag = active & (dir_ == 1)
        up = active & (dir_ == 2)
        left = active & (dir_ == 3)
        yield i, j, run, qsym, diag, up, left
        run = torch.where(up, run + 1, 0)
        i = i - (diag | up).to(torch.int64)
        j = j - (diag | left).to(torch.int64)
        active = active & (dir_ != 0) & (i >= 1) & (j >= 1)


def traceback_columns(dirs: torch.Tensor, qend: torch.Tensor,
                      tend: torch.Tensor, q: torch.Tensor, band: int,
                      Lt: int):
    """Lockstep traceback of a pair batch over banded_sw_batch_dirs'
    direction codes (``hga_tpu.ops.pileup.traceback_columns``): diagonal
    and left moves emit a column vote (read base / deletion symbol 4), up
    moves an insertion (read base inserted after the column, slot counted
    from the END of the insertion run).  qend 0 disables a row.

    Returns (sub_col, sub_sym, sub_ok, ins_col, ins_base, ins_slot,
    ins_ok), each (S, P) with S = Lq + Lt; int32 values, bool masks.
    """
    outs = [[] for _ in range(7)]
    for i, j, run, qsym, diag, up, left in _dirs_walk(
            dirs, qend, tend, q, band, Lt, stop_early=False):
        for o, x in zip(outs, (j - 1, torch.where(diag, qsym, 4),
                               diag | left, j - 1, qsym, run, up)):
            o.append(x)
    res = []
    for k, o in enumerate(outs):
        x = torch.stack(o)
        res.append(x if k in (2, 6) else x.to(torch.int32))
    return tuple(res)


def accumulate_backbone_votes_merged(
    merged: torch.Tensor,  # int32 (size_all + 1,) flat votes + sink slot
    dirs: torch.Tensor,    # int8 (D, P, W) from banded_sw_batch_dirs
    qend: torch.Tensor,    # int32 (P,) pre-masked 0 by the score gate
    tend: torch.Tensor,    # int32 (P,)
    q: torch.Tensor,       # int32 (P, Lq) oriented query codes
    bb: torch.Tensor,      # int32 (P,) backbone id per pair
    off: torch.Tensor,     # int32 (P,) window col -> forward backbone col
    lb: torch.Tensor,      # int32 (P,) backbone true length per pair
    *,
    size_v: int,
    lpad: int,
    band: int,
    Lt: int,
    ins_slots: int = 3,
) -> torch.Tensor:
    """Dirs traceback of one batch, its votes scatter-added into `merged`
    in place (and returned): ``hga_tpu.ops.pileup.
    accumulate_backbone_votes_merged``, with the moves the reference drops
    (index size_all, mode="drop") routed to the sink slot."""
    size_all = merged.shape[0] - 1
    i64 = lambda x: x.to(torch.int64)
    bb, off, lb = i64(bb), i64(off), i64(lb)
    base_v = bb * (lpad * N_SYM)
    base_i = bb * (lpad * ins_slots * 4) + size_v
    parts = []
    for i, j, run, qsym, diag, up, left in _dirs_walk(
            dirs, qend, tend, q, band, Lt, stop_early=True):
        colf = (j - 1) + off
        in_rng = (colf >= 0) & (colf < lb)
        sym = torch.where(diag, qsym, 4)
        parts.append(torch.where((diag | left) & in_rng,
                                 base_v + colf * N_SYM + sym, size_all))
        parts.append(torch.where(
            up & in_rng & (run < ins_slots),
            base_i + (colf * ins_slots + torch.clamp(run, 0, ins_slots - 1))
            * 4 + torch.clamp(qsym, 0, 3), size_all))
    if parts:
        idx = torch.cat(parts)
        merged.index_add_(0, idx, torch.ones(idx.shape[0], dtype=merged.dtype,
                                             device=merged.device))
    return merged


def accumulate_backbone_votes(
    votes: torch.Tensor,      # int32 (NB * lpad * N_SYM,) flat
    ins_votes: torch.Tensor,  # int32 (NB * lpad * ins_slots * 4,) flat
    dirs: torch.Tensor, qend: torch.Tensor, tend: torch.Tensor,
    q: torch.Tensor, bb: torch.Tensor, off: torch.Tensor, lb: torch.Tensor,
    lpad: int, band: int, Lt: int, ins_slots: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-buffer convenience over accumulate_backbone_votes_merged
    (``hga_tpu.ops.pileup.accumulate_backbone_votes``): returns new
    (votes, ins_votes) with one batch's dirs-traceback votes added; the
    inputs are left as they are."""
    size_v = votes.shape[0]
    merged = torch.cat([votes, ins_votes, votes.new_zeros(1)])
    accumulate_backbone_votes_merged(
        merged, dirs, qend, tend, q, bb, off, lb, size_v=size_v, lpad=lpad,
        band=band, Lt=Lt, ins_slots=ins_slots)
    return merged[:size_v], merged[size_v:-1]


def gate_max_ed(qlen: torch.Tensor, min_identity: float) -> torch.Tensor:
    """The correction gate's edit budget per pair: (1 - min_identity) * qlen
    in float32, truncated (the reference computes it in float32: at
    min_identity 0.9 and qlen a multiple of 10 it gives qlen / 10, where
    float64 gives one less)."""
    frac = torch.tensor(1.0 - min_identity, dtype=torch.float32,
                        device=qlen.device)
    return (frac * qlen.to(torch.float32)).to(torch.int32)


def myers_votes(merged: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                qlen: torch.Tensor, tlen: torch.Tensor, bb: torch.Tensor,
                off: torch.Tensor, lb: torch.Tensor,
                qw: Optional[torch.Tensor] = None, *, min_identity: float,
                size_v: int, lpad: int, ins_slots: int = 3,
                max_steps: Optional[int] = None
                ) -> Tuple[MyersResult, torch.Tensor]:
    """One correction batch: the Myers planes DP, the identity gate
    (dist <= gate_max_ed, qlen > 0, tend > 0), then the plane traceback's
    votes into `merged` (updated in place).  The plain version of K2'
    (ops/myers_cuda.myers_votes_cuda); the reference is ``votes_into`` of
    hga_tpu.models.correction._consensus_step_fn.  Returns (MyersResult,
    merged)."""
    res, pv, mv = myers_batch_planes(q, t, qlen, tlen)
    ok = (res.dist <= gate_max_ed(qlen, min_identity)) & (qlen > 0) \
        & (res.tend > 0)
    accumulate_backbone_votes_myers(
        merged, pv, mv, res.dist, torch.where(ok, qlen, 0), res.tend, q, t,
        bb, off, lb, qw, size_v=size_v, lpad=lpad, ins_slots=ins_slots,
        max_steps=max_steps)
    return res, merged


def consensus_call(votes: torch.Tensor, backbone: torch.Tensor,
                   min_depth: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column consensus symbol (argmax with +1 backbone prior).

    votes: flat (L*N_SYM,) or (L, N_SYM).  Returns (symbols int32 (L,),
    depth int32 (L,)); columns with depth < min_depth keep the backbone
    base; ties pick the lower symbol.
    """
    votes = votes.reshape(-1)
    bbk = backbone.to(torch.int64)
    planes = torch.stack([votes[s::N_SYM].to(torch.int64) + (bbk == s)
                          for s in range(5)])                # (5, L)
    depth = planes.sum(dim=0) - 1            # prior vote excluded
    best = torch.argmax(planes, dim=0)       # first maximum: ties -> lower
    out = torch.where(depth >= min_depth, best, bbk)
    return out.to(torch.int32), depth.to(torch.int32)


def consensus_and_insertions(merged: torch.Tensor, backbone: torch.Tensor, *,
                             min_depth: int, size_v: int, ins_slots: int,
                             cap: int):
    """Consensus symbols + SPARSE insertion calls, on the device.

    merged: the flat vote buffer (a trailing sink slot, if present, is
    ignored).  Returns (sym int8 (L,), n_ins, packed int64 (min(n_ins,
    cap),)) with packed[i] = ((col_flat * ins_slots + slot) << 2) | base for
    the called insertions in ascending flat order; n_ins > cap tells the
    caller to take the dense path, as in the reference.
    """
    L = backbone.shape[0]
    sym, depth = consensus_call(merged[:size_v], backbone,
                                min_depth=min_depth)
    ins = merged[size_v:size_v + L * ins_slots * 4].to(torch.int64)
    p0, p1, p2, p3 = (ins[b::4] for b in range(4))
    m01 = torch.maximum(p0, p1)
    a01 = (p1 > p0).to(torch.int64)
    m23 = torch.maximum(p2, p3)
    a23 = 2 + (p3 > p2).to(torch.int64)
    cnt = torch.maximum(m01, m23)
    best = torch.where(m23 > m01, a23, a01)
    col_of = torch.arange(cnt.shape[0], dtype=torch.int64,
                          device=cnt.device) // ins_slots
    need = torch.clamp((depth.to(torch.int64) + 1) // 2, min=min_depth)
    do = torch.nonzero(cnt >= need[col_of], as_tuple=True)[0]
    n = int(do.shape[0])
    packed = (do[:cap] << 2) | best[do[:cap]]
    return sym.to(torch.int8), n, packed
