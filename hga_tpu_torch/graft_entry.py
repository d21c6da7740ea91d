"""Entry points of the port for a compile check and a dry run: one compute
step, and the sharded steps on a world of ranks; the counterpart of the
repo root's ``__graft_entry__.py``.

    python -m hga_tpu_torch.graft_entry [--device cpu]

* ``entry(device)`` returns ``(fn, example_args)``: the flagship compute
  step, the banded-SW batch (ops/align_cuda.banded_sw_batch_cuda at band
  32, K3' on the card), on seed-0 inputs N 64, Lq 128, Lt 192 (int32
  codes, full lengths), drawn in the reference's order.
* ``dryrun_multichip(n_devices, device)`` starts n rank processes
  (parallel/launch.launch; NCCL for CUDA ranks with a card each, gloo for
  CPU ranks, by parallel/mesh.backend_rule) and runs in each the
  reference's steps on its draws from ``default_rng(0)``: owner-shard
  k-mer counting (``count_kmers_sharded``, shard_cap 512) and its
  histogram, ``route_by_bucket`` (bucket_cap 64),
  ``spectrum_hist_bucketed`` (bucket_cap 512), the data-parallel banded
  SW at band 16 (parallel/mesh.shard_batch_fn), ``myers_ring`` against a
  one-shot ``myers_batch_cuda``, and the 2 kb hybrid ``run_pipeline`` on
  the world.  It makes the reference's assertions, but for the overflow
  (see _dryrun_rank), and returns each rank's results (lists and
  numbers), in rank order.

The module runs on the card unless the caller asks for the CPU.  Running it
as a script prints entry()'s route and result shapes, runs
``dryrun_multichip(1)`` and prints ``ok``.
"""

from __future__ import annotations

import argparse
import functools
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

from hga_tpu_torch.ops.align_cuda import banded_sw_batch_cuda
from hga_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """(fn, example_args): K3''s wrapper at band 32 and its inputs."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    N, Lq, Lt = 64, 128, 192
    q = torch.from_numpy(rng.integers(0, 4, (N, Lq)).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 4, (N, Lt)).astype(np.int32))
    ql = torch.full((N,), Lq, dtype=torch.int32)
    tl = torch.full((N,), Lt, dtype=torch.int32)
    fn = functools.partial(banded_sw_batch_cuda, band=32)
    return fn, tuple(x.to(dev) for x in (q, t, ql, tl))


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 900.0) -> List[Dict]:
    """The reference's sharded steps on a world of `n_devices` ranks; each
    rank's results, in rank order."""
    from hga_tpu_torch.parallel.launch import launch

    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="hga_dryrun_") as td:
        return launch("hga_tpu_torch.graft_entry:_dryrun_rank", n_devices,
                      td, {"device": device}, device=device,
                      timeout=timeout)


def _dryrun_rank(device: str) -> Dict:
    """One rank of dryrun_multichip (parallel/launch.py calls it once the
    world is joined)."""
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.pipeline import run_pipeline
    from hga_tpu_torch.ops import align_cuda as AC
    from hga_tpu_torch.ops import count as C
    from hga_tpu_torch.ops import myers_cuda as MC
    from hga_tpu_torch.ops.align import SWResult
    from hga_tpu_torch.ops.kmer import words_to_tensor
    from hga_tpu_torch.ops.myers_cuda import myers_batch_cuda
    from hga_tpu_torch.parallel import collectives as PC
    from hga_tpu_torch.parallel.mesh import make_mesh, shard_batch_fn
    from hga_tpu_torch.parallel.ring_myers import myers_ring
    from hga_tpu_torch.utils import sim

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    n, r = mesh.size, mesh.rank
    k = 21
    rng = np.random.default_rng(0)

    def mine(x: np.ndarray) -> np.ndarray:      # this rank's block
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    def on(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # the reference's draws, in its order: reads (4 a rank, 64 bp pad), a
    # flat k-mer stream, an SW pair batch, the ring's queries and targets
    R, W = 4 * n, 4
    packed = rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32)
    bad = np.zeros((R, 2), np.uint32)
    length = np.full(R, 64, np.int32)
    M = 128 * n
    hi = rng.integers(0, 1 << 10, M).astype(np.uint32)
    lo = rng.integers(0, 2**32, M, dtype=np.uint64).astype(np.uint32)
    NP, Lq, Lt = 8 * n, 64, 96
    q = rng.integers(0, 4, (NP, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (NP, Lt)).astype(np.int32)
    ql, tl = np.full(NP, Lq, np.int32), np.full(NP, Lt, np.int32)

    rp, rb = (words_to_tensor(mine(x), dev) for x in (packed, bad))
    rl = on(mine(length))
    ck = PC.count_kmers_sharded(mesh, rp, rb, rl, k, shard_cap=512)
    hist = C.spectrum_histogram(ck, 16)
    r_hi, _, overflow = PC.route_by_bucket(
        mesh, on(mine(hi).astype(np.int64)), on(mine(lo).astype(np.int64)),
        bucket_cap=64)
    hist_b, of_b = PC.spectrum_hist_bucketed(mesh, rp, rb, rl, k,
                                             bucket_cap=512, max_count=16)
    sw_sharded = shard_batch_fn(
        mesh, functools.partial(banded_sw_batch_cuda, band=16), n_in=4,
        out_axes=SWResult)
    sw = sw_sharded(on(q), on(t), on(ql), on(tl))
    # the reference asserts overflow + of_b == 0, which its draws give from
    # 4 ranks on (the route's 128 k-mers a rank overflow its 64-slot lanes
    # at 1 and 2: 64 and 9); here every k-mer sent is received or counted
    # as overflow, at any world size, and the bucketed count loses none
    routed = PC.all_reduce_sum(
        (r_hi != C.SENTINEL).sum().reshape(1).to(torch.int64))
    assert int(hist.sum()) > 0
    assert int(routed[0]) + overflow == M and of_b == 0
    assert tuple(sw.score.shape) == (NP,)

    # ring sequence-parallel Myers: the target column-split over the ranks
    NQ, LQ, LT = 2 * n, 33, 64 * n
    qs = on(rng.integers(0, 4, (NQ, LQ)).astype(np.int32))
    ts = on(rng.integers(0, 4, (NQ, LT)).astype(np.int32))
    qls = torch.full((NQ,), LQ, dtype=torch.int32, device=dev)
    tls = torch.full((NQ,), LT, dtype=torch.int32, device=dev)
    ring = myers_ring(mesh, qs, ts, qls, tls)
    ref = myers_batch_cuda(qs, ts, qls, tls)
    assert torch.equal(ring.dist, ref.dist)
    assert torch.equal(ring.tend, ref.tend)

    # the hybrid pipeline end to end on the world, on a 2 kb dataset
    ds = sim.make_dataset(genome_len=2000, short_cov=20, long_cov=10, seed=2,
                          short_err=0.005, long_err=0.08)
    pr_s = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=128)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    pr_l = pack_reads(ds.long_seqs, names=ds.long_names,
                      category=[1] * len(ds.long_seqs), pad_len=pad)
    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=256,
                          min_shared_minimizers=2, min_overlap_len=30)
    with tempfile.TemporaryDirectory(prefix="hga_dryrun_pipe_") as td:
        res = run_pipeline(pr_s, pr_l, cfg, td, device=dev, mesh=mesh)
    assert res.polished and all(len(s) > 0 for _, s in res.polished)

    lst = lambda x: x.cpu().tolist()
    launches = {k: v for L in (MC.LAUNCHES, AC.LAUNCHES)
                for k, v in L.items() if v}
    return dict(hist=lst(hist), hist_bucketed=lst(hist_b),
                overflow=int(overflow), overflow_bucketed=int(of_b),
                sw_score=lst(sw.score), sw_qend=lst(sw.qend),
                sw_tend=lst(sw.tend), ring_dist=lst(ring.dist),
                ring_tend=lst(ring.tend),
                polished=[list(c) for c in res.polished],
                launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (gloo ranks, plain versions)")
    device = ap.parse_args(argv).device
    from hga_tpu_torch.ops.align_cuda import route

    fn, args = entry(device)
    out = fn(*args)
    kind = route(args[0].shape[1], args[1].shape[1], fn.keywords["band"]).kind
    print(f"entry: banded_sw_batch_cuda band {fn.keywords['band']} on "
          f"{args[0].device}, route {kind}: " + ", ".join(
              f"{f} {tuple(x.shape)} {x.dtype}"
              for f, x in zip(out._fields, out)), flush=True)
    (rank0,) = dryrun_multichip(1, device)
    print(f"dryrun_multichip(1): backend {rank0['backend']}, "
          f"{len(rank0['polished'])} polished contig(s), launches "
          f"{rank0['launches']}", flush=True)
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
