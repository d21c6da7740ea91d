"""Microbenchmark: correction's device path, the Myers planes DP, the plane
traceback and the vote scatter, at the correction shape.

Counterpart of exp/bench_corr_tb.py, on the same inputs: P pairs of random
codes (``default_rng(0)``), Lq 112, band 64, target windows Wt = Lq + band
+ 8 = 184, votes into 64 backbones of Lpad 8192.  Three lines, as there:

  dp_only        the planes DP alone: K2, ``myers_batch_planes_cuda``
  fused_full_S   DP, gate, traceback and votes in one launch: K2',
                 ``myers_votes_cuda`` with max_steps None
  fused_bounded  K2' with the walk bounded at max_steps = Lq + 28 + 2

The gate is the JAX script's ``dist <= 28``: K2' gates on (1 -
min_identity) * qlen in float32, which at min_identity 0.75 and qlen 112
is 28.  Each is timed with CUDA events over `iters` calls that cycle
through four input sets (the queries rotated, (q + i) % 4) after a warm-up
call on each (on the CPU, by the host clock).  The ms are printed with
four decimals, where the JAX script printed one.

On those random inputs no pair passes the gate (a random 112-mer is far
more than 28 edits from any window), so no walk runs.  ``run`` therefore
also returns the vote buffer each way gives on planted pairs of the same
shapes (each query a window of its target with 3% substitutions, every
pair gated in): the K2 planes walked by the plain traceback
(``pileup.accumulate_backbone_votes_myers``) and the two K2' launches.
The three must be equal less the buffer's last slot, the sink of dropped
moves, which the plain traceback writes and K2' never does.

    python -m hga_tpu_torch.exp.bench_corr_tb [P=4096] [iters=8]
        [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from hga_tpu_torch.exp.common import split_device
from hga_tpu_torch.ops import pileup as PU
from hga_tpu_torch.ops.myers_cuda import (myers_batch_planes_cuda,
                                          myers_votes_cuda)
from hga_tpu_torch.utils.benchmarks import time_ms
from hga_tpu_torch.utils.device import resolve_device

LQ, BAND = 112, 64
MAX_ED = 28
MIN_IDENTITY = 0.75          # float32 (1 - 0.75) * 112 = 28 = MAX_ED
NB, LPAD = 64, 8192
INS_SLOTS = 3
N_SETS = 4


def inputs(P: int, dev: torch.device):
    """The JAX script's operands on `dev`: (q, t, qlen, tlen, bb, off, lb)
    and the vote buffer's column-vote size."""
    Wt = LQ + BAND + 8
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (P, LQ)).astype(np.int32)
    t = rng.integers(0, 4, (P, Wt)).astype(np.int32)
    ql = np.full(P, LQ, np.int32)
    tl = np.full(P, Wt, np.int32)
    bb = rng.integers(0, NB, P).astype(np.int32)
    off = rng.integers(0, LPAD - Wt, P).astype(np.int32)
    lb = np.full(P, LPAD, np.int32)
    return (tuple(torch.from_numpy(x).to(dev)
                  for x in (q, t, ql, tl, bb, off, lb)),
            NB * LPAD * PU.N_SYM)


def planted(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Queries that are windows of their targets with 3% substitutions
    (seed 1)."""
    rng = np.random.default_rng(1)
    tt = t.cpu().numpy()
    P, Wt = tt.shape
    start = rng.integers(0, Wt - LQ + 1, P)
    qq = tt[np.arange(P)[:, None], start[:, None] + np.arange(LQ)]
    sub = rng.random((P, LQ)) < 0.03
    qq = np.where(sub, (qq + rng.integers(1, 4, (P, LQ))) % 4, qq)
    return torch.from_numpy(qq.astype(np.int32)).to(q.device)


def run(P: int = 4096, iters: int = 8, device="cuda") -> Dict:
    dev = resolve_device(device)
    (q, t, ql, tl, bb, off, lb), size_v = inputs(P, dev)
    size_all = size_v + NB * LPAD * INS_SLOTS * 4
    sets = [((q + i) % 4, t, ql, tl) for i in range(N_SETS)]
    fresh = lambda: torch.zeros(size_all + 1, dtype=torch.int32, device=dev)

    def fused(qq, tt, qql, ttl, max_steps):
        return myers_votes_cuda(fresh(), qq, tt, qql, ttl, bb, off, lb,
                                min_identity=MIN_IDENTITY, size_v=size_v,
                                lpad=LPAD, ins_slots=INS_SLOTS,
                                max_steps=max_steps)

    bounded = LQ + MAX_ED + 2
    fns = (("dp_only", myers_batch_planes_cuda),
           ("fused_full_S", lambda *a: fused(*a, None)),
           ("fused_bounded", lambda *a: fused(*a, bounded)))
    times = {name: time_ms(fn, sets, iters, dev, passes=1)
             for name, fn in fns}

    r = myers_batch_planes_cuda(*sets[0])[0]
    gated = int(((r.dist <= MAX_ED) & (r.tend > 0)).sum())

    # the vote buffers of planted pairs, each way
    qp = planted(q, t)
    r, pv, mv = myers_batch_planes_cuda(qp, t, ql, tl)
    ok = (r.dist <= MAX_ED) & (r.tend > 0)
    unfused = PU.accumulate_backbone_votes_myers(
        fresh(), pv, mv, r.dist, torch.where(ok, ql, 0), r.tend, qp, t, bb,
        off, lb, size_v=size_v, lpad=LPAD, ins_slots=INS_SLOTS)
    merged = {"dp_only": unfused,
              "fused_full_S": fused(qp, t, ql, tl, None)[1],
              "fused_bounded": fused(qp, t, ql, tl, bounded)[1]}
    return dict(P=P, iters=iters, device=dev.type, ms=times, gated=gated,
                planted_gated=int(ok.sum()), merged=merged)


def main(argv: Optional[List[str]] = None) -> Dict:
    args, device = split_device(argv)
    P = int(args[0]) if len(args) > 0 else 4096
    iters = int(args[1]) if len(args) > 1 else 8
    out = run(P, iters, device)
    for name, ms in out["ms"].items():
        dt = ms * 1e-3
        print(f"{name}: {ms:.4f} ms/batch = {P / dt:,.0f} aln/s", flush=True)
    return out


if __name__ == "__main__":
    main()
