"""L6 — the ring Myers engine: a long target split by columns over the ranks,
the DP's column state handed rank to rank (port of
``hga_tpu.parallel.ring_myers``).

The whole dependency between two column chunks of semi-global edit
distance is each query's column state (pv, mv, score, best, bj): a few
words a query.  Rank d holds target columns [d C, (d + 1) C).  The queries
are cut into B = blocks_per_dev * P blocks and pipelined: at ring step s,
rank d runs block s - d on its chunk from the state it received, starting
at global column j0 = d C; rank 0 admits a fresh block; after every step
every rank sends its state to rank d + 1 and receives rank d - 1's (one
batch_isend_irecv), active or not, as ``ppermute`` does.  The last rank
drains finished blocks, and an all_reduce(SUM) replicates the results
(the other ranks contribute zeros).  B + P - 1 steps for B blocks.

On the card each step's DP is K1''s carried-state mode
(ops/myers_cuda.myers_cols_cuda: its shared mode for a one-row target, its
per-pair mode otherwise); on the CPU its plain version ops/myers.myers_cols.
Bit-exact with one myers_batch over the whole target.
"""

from __future__ import annotations

import torch

from hga_tpu_torch.ops.myers import (MyersResult, myers_init_state, n_words,
                                     pack_state, unpack_state)
from hga_tpu_torch.ops.myers_cuda import myers_cols_cuda
from hga_tpu_torch.parallel.collectives import all_reduce_sum, ring_shift
from hga_tpu_torch.parallel.mesh import Mesh


def myers_ring(mesh: Mesh, q: torch.Tensor, t: torch.Tensor,
               qlen: torch.Tensor, tlen: torch.Tensor,
               blocks_per_dev: int = 2) -> MyersResult:
    """Semi-global edit distance with the target column-split over the
    ranks.

    q: codes (N, Lq); t: (N, Lt) or one row (1, Lt) shared by every query
    (each rank keeps its C = Lt / P columns of it).  Every rank passes the
    same q, t, qlen, tlen; N must divide into B = blocks_per_dev * P blocks
    and Lt into P chunks (callers pad queries with qlen 0 rows and targets
    with sentinel columns).  Results replicated on every rank.
    """
    P, d = mesh.size, mesh.rank
    q = q.to(torch.int32).contiguous()
    t = t.to(torch.int32)
    ql = qlen.to(torch.int32).contiguous()
    tl = tlen.to(torch.int32).contiguous()
    N, Lq = q.shape
    Nt, Lt = t.shape
    shared = Nt == 1
    if not shared and Nt != N:
        raise ValueError(f"t rows {Nt} must be 1 (shared) or N={N}")
    B = blocks_per_dev * P
    if N % B or Lt % P:
        raise ValueError(f"N={N} must divide blocks B={B} and Lt={Lt} "
                         f"must divide n_dev={P}")
    NB, C, W = N // B, Lt // P, n_words(Lq)
    t_mine = t[:, d * C:(d + 1) * C].contiguous()

    def blk(x, b):
        return x[b * NB:(b + 1) * NB]

    state = pack_state(myers_init_state(ql[:NB], W))
    res = torch.zeros((2, B, NB), dtype=torch.int32, device=q.device)
    for s in range(B + P - 1):
        b = s - d
        if s < B and d == 0:          # rank 0 admits a fresh block
            state = pack_state(myers_init_state(blk(ql, s), W))
        if 0 <= b < B:
            new, _ = myers_cols_cuda(
                blk(q, b), t_mine if shared else blk(t_mine, b).contiguous(),
                blk(ql, b), blk(tl, b), unpack_state(state, W), j0=d * C)
            state = pack_state(new)
            if d == P - 1:            # the last rank drains finished blocks
                live = blk(ql, b) > 0
                res[0, b] = torch.where(live, state[:, 2 * W + 1], 0)
                res[1, b] = torch.where(live, state[:, 2 * W + 2], 0)
        state = ring_shift(state)
    res = all_reduce_sum(res)
    return MyersResult(dist=res[0].reshape(N), tend=res[1].reshape(N))
