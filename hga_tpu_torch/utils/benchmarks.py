"""Benchmarks of the port: GCUPS for the DP kernels, reads/s for counting
and the short-read pipeline (``hga-torch bench``).

Counterpart of ``hga_tpu.utils.benchmarks.run_benchmark`` with the modes
``sw`` (K3), ``myers`` (K1), ``count``, ``pipeline`` and ``correction``
(both correction engines: K2' for "myers", the plain-torch scored dirs DP
for "sw"), ``scaling`` (counting reads/s on one rank, then owner-shard
counting over the world of ranks) and ``comm`` (the analytic bytes each
host moves a stage): the same shapes, JSON keys and cell counts.

Roofline of one H100 SXM (NVIDIA data sheet), computed for each shape:

  int32 issue   132 SMs x 64 lanes x 1.98 GHz = 16.7e12 operations/s
  HBM3          3.35e12 bytes/s
  banded SW     12 int32 operations per in-band cell
  Myers         20 int32 operations per word, target column and pair
  traceback     40 int32 operations per walk step (K2')

``roofline_gcups`` = cells / max(operations / int32 rate, bytes / HBM
rate), each input read once and each output written once; ``baseline_gcups``
= 0.7 x roofline, the reference's share.  The int32 rate is the data
sheet's; ``python -m hga_tpu_torch.exp.vpu_micro`` measures it.

Timing: on the card, CUDA events around `reps` calls that cycle through
distinct input sets after one warm-up call per set, best of 3 passes
(``cuda_ms``); on the CPU, ``time.perf_counter``.  Every result names the
device it ran on, and on the card its power limit.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hga_tpu_torch.utils.device import resolve_device

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; int32 ALU issue 64
# lanes per SM per clock x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per word, target column and pair in the Myers recurrence
# after the compiler's 3-input logic fusion (about 37 source-level ops)
OPS_PER_WORD_COLUMN = 20
# int32 operations per step of the plane traceback (K2'): the W-word masked
# prefix popcount of one column (about 4 W), two vertical-delta bits, the
# substitution test, the three move tests and the state updates (about 25)
# at the correction width W 4
OPS_PER_WALK_STEP = 40
# int32 operations per in-band cell of the SW recurrence (the Pallas
# kernel's CostEstimate, hga_tpu/ops/align_pallas.py:222)
SW_OPS_PER_CELL = 12
BASELINE_SHARE = 0.7

PASSES = 3


def bound_ms(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time (ms) the card could take for `ops` int32 operations
    and `nbytes` bytes of device memory traffic, and which of the two
    bounds it."""
    op_ms = 1e3 * ops / INT32_OPS_PER_S
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(op_ms, byte_ms), ("bytes" if byte_ms > op_ms else "operations")


def cuda_ms(fn: Callable, arg_sets: Sequence[tuple], reps: int,
            passes: int = 1) -> float:
    """Mean ms per call over `reps` calls cycling through distinct inputs,
    after one warm-up call per input set (CUDA events); the best of
    `passes` passes."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / reps)
    return best


def host_ms(fn: Callable, arg_sets: Sequence[tuple], reps: int,
            passes: int = 1) -> float:
    """cuda_ms's counterpart on the CPU (time.perf_counter)."""
    for a in arg_sets:
        fn(*a)
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for r in range(reps):
            fn(*arg_sets[r % len(arg_sets)])
        best = min(best, 1e3 * (time.perf_counter() - t0) / reps)
    return best


def time_ms(fn: Callable, arg_sets: Sequence[tuple], reps: int,
            dev: torch.device, passes: int = PASSES) -> float:
    clock = cuda_ms if dev.type == "cuda" else host_ms
    return clock(fn, arg_sets, reps, passes)


def card_line() -> str:
    """The card's `name, power.limit` as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_info(dev: torch.device) -> Dict[str, str]:
    """What a result ran on: the card's name and power limit, or the CPU."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    name, _, limit = card_line().partition(",")
    return {"device": name.strip(), "power_limit": limit.strip()}


def _rates(impl: str, ms: float, cells: int, ops: float, nbytes: float,
           dev: torch.device) -> Dict:
    b_ms, by = bound_ms(ops, nbytes)
    roof = cells / (b_ms * 1e-3) / 1e9
    return {"impl": impl, "seconds": ms * 1e-3,
            "gcups": cells / (ms * 1e-3) / 1e9, "cells": cells,
            "roofline_gcups": roof, "baseline_gcups": BASELINE_SHARE * roof,
            "bound_ms": b_ms, "bound_by": by, **device_info(dev)}


def _random_pairs(n_pairs: int, Lq: int, Lt: int, dev: torch.device,
                  n_sets: int):
    """Uniform random codes, full lengths (the reference's bench inputs);
    `n_sets` distinct query sets (q + i) % 4 share one target set."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (n_pairs, Lq)).astype(np.int32)
    t = torch.from_numpy(rng.integers(0, 4, (n_pairs, Lt)).astype(np.int32))
    ql = torch.full((n_pairs,), Lq, dtype=torch.int32)
    tl = torch.full((n_pairs,), Lt, dtype=torch.int32)
    return [tuple(x.to(dev) for x in (torch.from_numpy((q + i) % 4), t, ql,
                                      tl)) for i in range(n_sets)]


def _sets_reps(dev: torch.device) -> Tuple[int, int]:
    return (4, 20) if dev.type == "cuda" else (2, 2)


def bench_sw(n_pairs: int = 8192, Lq: int = 128, Lt: int = 256,
             band: int = 64, device="cuda") -> Dict:
    """Banded-SW GCUPS (K3) on config-3-shaped pairs (short read vs long
    window); cells are the in-band cells (sw_cells)."""
    from hga_tpu_torch.ops.align import sw_cells
    from hga_tpu_torch.ops.align_cuda import banded_sw_batch_cuda

    dev = resolve_device(device)
    n_sets, reps = _sets_reps(dev)
    sets = _random_pairs(n_pairs, Lq, Lt, dev, n_sets)
    ms = time_ms(lambda *a: banded_sw_batch_cuda(*a, band=band), sets, reps,
                 dev)
    cells = sw_cells([Lq], [Lt], band) * n_pairs
    nbytes = 4 * n_pairs * (Lq + Lt) + 8 * n_pairs + 12 * n_pairs
    out = _rates("cuda_k3" if dev.type == "cuda" else "plain", ms, cells,
                 cells * SW_OPS_PER_CELL, nbytes, dev)
    out.update(n_pairs=n_pairs, Lq=Lq, Lt=Lt, band=band)
    return out


def bench_myers(n_pairs: int = 8192, Lq: int = 128, Lt: int = 192,
                device="cuda") -> Dict:
    """Overlap-gate GCUPS (K1) on config-3-shaped pairs; cells are the full
    Lq x Lt matrix per pair, as in the reference."""
    from hga_tpu_torch.ops.myers import n_words
    from hga_tpu_torch.ops.myers_cuda import myers_batch_cuda

    dev = resolve_device(device)
    n_sets, reps = _sets_reps(dev)
    sets = _random_pairs(n_pairs, Lq, Lt, dev, n_sets)
    ms = time_ms(myers_batch_cuda, sets, reps, dev)
    cells = n_pairs * Lq * Lt
    ops = n_pairs * Lt * n_words(Lq) * OPS_PER_WORD_COLUMN
    nbytes = 4 * n_pairs * (Lq + Lt) + 8 * n_pairs + 8 * n_pairs
    out = _rates("cuda_k1" if dev.type == "cuda" else "plain", ms, cells, ops,
                 nbytes, dev)
    out.update(n_pairs=n_pairs, Lq=Lq, Lt=Lt)
    return out


def bench_correction(n_pairs: int = 4096, Lq: int = 112, band: int = 64,
                     engine: str = "myers", device="cuda") -> Dict:
    """Correction-step alignments/s: one batch's DP, traceback and vote
    scatter (models/correction._votes_into, cfg.corr_engine), on the
    reference's shapes and inputs: read pad 112, window Lq + band + 8, 8
    backbones of 4096 columns, random codes from default_rng(0), the
    queries rotated by the step ((q + i) % 4), one vote buffer carried
    across the steps.  Cells are Lq x Wt a pair, as in the reference."""
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.models.correction import INS_SLOTS, _votes_into
    from hga_tpu_torch.ops.pileup import N_SYM

    dev = resolve_device(device)
    cfg = AssemblerConfig(band=band, corr_engine=engine)
    Wt = Lq + band + 8
    nb, Lpad = 8, 4096
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (n_pairs, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (n_pairs, Wt)).astype(np.int32)
    ql = np.full(n_pairs, Lq, np.int32)
    tl = np.full(n_pairs, Wt, np.int32)
    bb = rng.integers(0, nb, n_pairs).astype(np.int32)
    off = rng.integers(0, Lpad - Wt, n_pairs).astype(np.int32)
    lb = np.full(n_pairs, Lpad, np.int32)
    size_v = nb * Lpad * N_SYM
    merged = torch.zeros(size_v + nb * Lpad * INS_SLOTS * 4 + 1,
                         dtype=torch.int32, device=dev)
    # the reference's 32 inner steps rotate the queries by the step: four
    # distinct query sets
    n_sets, reps = (4, 32) if dev.type == "cuda" else (2, 2)
    sets = [tuple(torch.from_numpy(x).to(dev)
                  for x in ((q + i) % 4, t, ql, tl, bb, off, lb))
            for i in range(n_sets)]
    ms = time_ms(lambda *a: _votes_into(merged, cfg, size_v, Lpad, *a),
                 sets, reps, dev)
    dt = ms * 1e-3
    cells = n_pairs * Lq * Wt
    impl = "plain" if dev.type != "cuda" else (
        "cuda_k2v" if engine == "myers" else "torch")
    return {"engine": engine, "impl": impl, "seconds": dt,
            "aln_per_s": n_pairs / dt, "gcups": cells / dt / 1e9,
            "n_pairs": n_pairs, "Lq": Lq, "Wt": Wt, **device_info(dev)}


def bench_count(n_reads: int = 8192, read_len: int = 112, k: int = 21,
                device="cuda") -> Dict:
    """Config-1 counting reads/s: extract canonical k-mers, sort-count,
    histogram (ops/kmer, ops/count; plain torch, no kernel of its own)."""
    from hga_tpu_torch.ops import count as C
    from hga_tpu_torch.ops import kmer as K

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    W = read_len // 16
    packed = K.words_to_tensor(rng.integers(0, 2**32, (n_reads, W),
                                            dtype=np.uint64).astype(np.uint32),
                               dev)
    bad = torch.zeros((n_reads, (read_len + 31) // 32), dtype=torch.int32,
                      device=dev)
    length = torch.full((n_reads,), read_len, dtype=torch.int32, device=dev)

    def step(p):
        kb = K.extract_kmers(p, bad, length, k)
        hi = torch.where(kb.valid, kb.hi, C.SENTINEL)
        lo = torch.where(kb.valid, kb.lo, C.SENTINEL)
        ck = C.sort_and_count(hi, lo, kb.valid.to(torch.int32))
        return C.spectrum_histogram(ck, 64)

    n_sets, reps = _sets_reps(dev)
    ms = time_ms(step, [(packed ^ i,) for i in range(n_sets)], reps, dev)
    dt = ms * 1e-3
    return {"impl": "torch" if dev.type == "cuda" else "plain",
            "seconds": dt, "reads_per_s": n_reads / dt,
            "kmers_per_s": n_reads * (read_len - k + 1) / dt,
            **device_info(dev)}


def bench_pipeline(genome_len: int = 20_000, coverage: float = 20.0,
                   device="cuda") -> Dict:
    """Small end-to-end short-read assembly reads/s: find_candidates ->
    compute_overlaps -> assemble, host clock around the three stages."""
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.assembly import assemble
    from hga_tpu_torch.models.overlap import compute_overlaps
    from hga_tpu_torch.models.seeding import find_candidates
    from hga_tpu_torch.utils import sim

    dev = resolve_device(device)
    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=2048,
                          min_shared_minimizers=2, min_overlap_len=30)
    genome = sim.random_genome(genome_len, seed=0)
    seqs, names = sim.simulate_short_reads(genome, coverage=coverage,
                                           read_len=120, error_rate=0.003,
                                           seed=1)
    pr = pack_reads(seqs, names=names, pad_len=128)
    t0 = time.perf_counter()
    cands = find_candidates(pr, cfg, device=dev)
    ov = compute_overlaps(pr, cands, cfg, device=dev)
    res = assemble(pr, ov, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"reads": pr.n_reads, "seconds": dt,
            "reads_per_s": pr.n_reads / dt, "contigs": len(res.contigs),
            **device_info(dev)}


def bench_scaling(n_reads: int = 16384, read_len: int = 112, k: int = 21,
                  device="cuda") -> Dict:
    """Counting-stage reads/s on one rank, then over the world of ranks by
    owner-shard counting (parallel/collectives.spectrum_hist_bucketed: one
    all_to_all route, each rank counting its own bucket of its n/P reads).
    Host clock around synchronized calls (the collectives are on the path).
    Ranks that share a card (gloo, staged through host memory) measure the
    path's cost, not a scaling: the result says so in `note`."""
    from hga_tpu_torch.ops import count as C
    from hga_tpu_torch.ops import kmer as K
    from hga_tpu_torch.parallel import collectives as PC
    from hga_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    mesh = make_mesh()
    P = mesh.size
    rng = np.random.default_rng(0)
    W = read_len // 16
    packed = K.words_to_tensor(rng.integers(0, 2**32, (n_reads, W),
                                            dtype=np.uint64).astype(np.uint32),
                               dev)
    bad = torch.zeros((n_reads, (read_len + 31) // 32), dtype=torch.int32,
                      device=dev)
    length = torch.full((n_reads,), read_len, dtype=torch.int32, device=dev)

    def single(p, b, l):
        kb = K.extract_kmers(p, b, l, k)
        hi = torch.where(kb.valid, kb.hi, C.SENTINEL)
        lo = torch.where(kb.valid, kb.lo, C.SENTINEL)
        ck = C.sort_and_count(hi, lo, kb.valid.to(torch.int32))
        return C.spectrum_histogram(ck, 16)

    def time_one(f, args, n=3):
        f(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            f(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / n

    dt1 = time_one(single, (packed, bad, length))
    out = {"devices": P, "reads": n_reads,
           "single_reads_per_s": n_reads / dt1, **device_info(dev)}
    if P > 1:
        nb = n_reads // P
        mine = slice(mesh.rank * nb, (mesh.rank + 1) * nb)
        cap = 2 * nb * (read_len - k + 1) // P + 64

        def sharded(p, b, l):
            hist, _ = PC.spectrum_hist_bucketed(mesh, p, b, l, k, cap, 16)
            return hist

        dtn = time_one(sharded, (packed[mine], bad[mine], length[mine]))
        out["sharded_reads_per_s"] = n_reads / dtn
        out["scaling_efficiency"] = dt1 / dtn  # the same total work
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if dev.type != "cuda" or P > n_cards:
            out["note"] = (f"{P} ranks share {dev.type} ({n_cards} card(s)): "
                           "a cost of the distributed path, not a scaling "
                           "figure")
    return out


def comm_volume_model(
    n_short: int = 1_380_000,
    n_long: int = 10_600,
    read_len: int = 100,
    long_len_mean: int = 8000,
    genome_len: int = 4_600_000,
    k: int = 21,
    n_hosts: int = 2,
    chips_per_host: int = 4,
    n_overlaps: Optional[int] = None,
    dcn_gbps: float = 25.0,
) -> Dict:
    """Analytic bytes over the network between hosts per pipeline stage for
    an n-host run (the reference's model, the same arithmetic and dict):
    owner-shard all_to_all counting, host-partitioned blocks re-replicated
    by rank-ordered gathers (parallel/collectives.py, parallel/hostpart.py).
    Defaults are the judged E. coli-scale hybrid set (4.6 Mb, cov 30/20)."""
    assert n_hosts >= 1 and chips_per_host >= 1
    cross = (n_hosts - 1) / n_hosts      # share of routed data that leaves
    # the host under a host-major layout (uniform hash)
    stages: Dict[str, Dict] = {}
    # counting: every k-mer routed once to its owner as an (hi, lo) pair
    n_kmers = n_short * max(read_len - k + 1, 0)
    local_kmers = n_kmers / n_hosts
    stages["count_route"] = {
        "dcn_bytes_per_host": int(local_kmers * 8 * cross),
        "what": "owner-shard all_to_all of (hi,lo) k-mer pairs",
    }
    # correction: every host receives the other hosts' corrected bases
    corr_bases = n_long * long_len_mean
    stages["corrected_gather"] = {
        "dcn_bytes_per_host": int(corr_bases * cross),
        "what": "rank-ordered allgather of corrected long reads",
    }
    # overlaps: survivors re-replicate as 11 int32 fields per record,
    # ~12 dovetails per corrected read by default
    if n_overlaps is None:
        n_overlaps = 12 * n_long
    stages["overlap_gather"] = {
        "dcn_bytes_per_host": int(n_overlaps * 11 * 4 * cross),
        "what": "rank-ordered allgather of PAF-shaped overlap records",
    }
    # polish: contig sequences (~genome size) re-replicate once
    stages["polish_gather"] = {
        "dcn_bytes_per_host": int(genome_len * cross),
        "what": "rank-ordered allgather of polished contigs",
    }
    total = sum(s["dcn_bytes_per_host"] for s in stages.values())
    t_dcn = total / (dcn_gbps * 1e9 / 8)
    return {
        "n_hosts": n_hosts,
        "chips_per_host": chips_per_host,
        "stages": stages,
        "total_dcn_bytes_per_host": total,
        "dcn_gbps": dcn_gbps,
        "dcn_seconds": round(t_dcn, 3),
        "note": "compare dcn_seconds against measured single-host stage "
                "seconds/n_hosts (metrics_*.json): efficiency bound "
                "t_comp / (t_comp/n + dcn_seconds)",
    }


def run_benchmark(what: str = "sw", n_pairs: int = 4096,
                  device="cuda") -> Dict:
    if what == "sw":
        return bench_sw(n_pairs=n_pairs, device=device)
    if what == "myers":
        return bench_myers(n_pairs=n_pairs, device=device)
    if what == "count":
        return bench_count(device=device)
    if what == "pipeline":
        return bench_pipeline(device=device)
    if what == "correction":
        return {eng: bench_correction(n_pairs=n_pairs, engine=eng,
                                      device=device)
                for eng in ("myers", "sw")}
    if what == "scaling":
        return bench_scaling(device=device)
    if what == "comm":
        return comm_volume_model()
    raise ValueError(what)
