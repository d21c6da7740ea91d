"""L4 ops — CSR overlap graph + transitive reduction as sorted joins (PyTorch).

Counterpart of ``hga_tpu.ops.graph``: nodes are oriented reads, edges live
in sorted flat tensors, adjacency is (row_ptr, sorted edge list), and the
transitive reduction checks each edge's bounded out-neighbourhood with one
two-key lookup per neighbour rank.  The graph is O(#reads); it runs on
whichever device the caller names, with the same result.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_KEY = 1 << 32


def lookup_sorted(set_a: torch.Tensor, set_b: torch.Tensor,
                  set_val: torch.Tensor, q_a: torch.Tensor,
                  q_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query key (q_a, q_b), find it in the set and return its value.

    Returns (found bool, val int64); val is the set value of the match (the
    largest one should a key repeat, as the reference's run-max does) or 0.
    Keys are non-negative and below 2^31 in each half.
    """
    skey = set_a.to(torch.int64) * _KEY + set_b.to(torch.int64)
    # sort by (key, value): the last slot of a key's run holds its max value
    o1 = torch.argsort(set_val.to(torch.int64), stable=True)
    o2 = torch.argsort(skey[o1], stable=True)
    order = o1[o2]
    skey, sval = skey[order], set_val.to(torch.int64)[order]
    qkey = q_a.to(torch.int64) * _KEY + q_b.to(torch.int64)
    if skey.numel() == 0:
        z = torch.zeros(qkey.shape, dtype=torch.bool, device=qkey.device)
        return z, torch.zeros(qkey.shape, dtype=torch.int64, device=qkey.device)
    pos = torch.searchsorted(skey, qkey, right=True) - 1
    posc = torch.clamp(pos, min=0)
    found = (pos >= 0) & (skey[posc] == qkey)
    return found, torch.where(found, sval[posc], 0)


class CSR(NamedTuple):
    """Sorted edge list + row pointers; invalid edges sit at the tail with
    u == n_nodes."""

    u: torch.Tensor        # int64 (E,) sorted by (u, length, v)
    v: torch.Tensor
    length: torch.Tensor   # extension length of the edge
    score: torch.Tensor    # overlap score
    row_ptr: torch.Tensor  # (n_nodes+1,)
    deg: torch.Tensor      # (n_nodes,)
    n_edges: int


def build_csr(u, v, length, score, valid, n_nodes: int) -> CSR:
    """Sort edges by (u, length, v) and build row pointers."""
    u = torch.where(valid, u.to(torch.int64), n_nodes)
    length, v, score = (x.to(torch.int64) for x in (length, v, score))
    order = torch.argsort(v, stable=True)
    order = order[torch.argsort(length[order], stable=True)]
    order = order[torch.argsort(u[order], stable=True)]
    u_s, len_s, v_s, sc_s = u[order], length[order], v[order], score[order]
    deg = torch.bincount(u_s[u_s < n_nodes], minlength=n_nodes)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=u.device),
                         torch.cumsum(deg, 0)])
    return CSR(u=u_s, v=v_s, length=len_s, score=sc_s, row_ptr=row_ptr,
               deg=deg, n_edges=int(valid.sum()))


def transitive_reduction(csr: CSR, n_nodes: int, max_out: int = 16,
                         fuzz: int = 10) -> torch.Tensor:
    """Myers-style reduction mask over a CSR graph (True = keep the edge).

    Edge u->w is reducible iff some 2-path u->v->w satisfies
    len(u->v) + len(v->w) <= len(u->w) + fuzz, checking at most max_out
    (shortest) out-neighbours of u.
    """
    E = csr.u.shape[0]
    dev = csr.u.device
    valid = csr.u < n_nodes
    reducible = torch.zeros(E, dtype=torch.bool, device=dev)
    safe_u = torch.where(valid, csr.u, 0)
    set_a = torch.where(valid, csr.u, n_nodes + 1)
    eidx = torch.arange(E, dtype=torch.int64, device=dev)
    for r in range(max_out):
        slot = torch.clamp(csr.row_ptr[safe_u] + r, 0, E - 1)
        vr = csr.v[slot]                  # r-th shortest out-neighbour of u
        l_uv = csr.length[slot]
        in_deg = r < csr.deg[safe_u]
        q_a = torch.where(valid & in_deg, vr, n_nodes)
        found, l_vw = lookup_sorted(set_a, csr.v, csr.length, q_a, csr.v)
        hit = (valid & in_deg & found
               & (vr != csr.v)                 # v == w is the edge itself
               & (slot != eidx)                # skip u->w as its own via
               & (l_uv + l_vw <= csr.length + fuzz))
        reducible = reducible | hit
    return valid & ~reducible
