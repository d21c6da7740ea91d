"""Benchmarks of the port: GCUPS for the DP kernels, reads/s for counting
and the short-read pipeline (``hga-torch bench``).

Counterpart of ``hga_tpu.utils.benchmarks.run_benchmark`` with the modes
``sw`` (K3), ``myers`` (K1), ``count`` and ``pipeline``: the same shapes,
JSON keys and cell counts.  ``correction`` (needs ``corr_engine="sw"``),
``scaling`` and ``comm`` (need distribution) raise NotImplementedError.

Roofline of one H100 SXM (NVIDIA data sheet), computed for each shape:

  int32 issue   132 SMs x 64 lanes x 1.98 GHz = 16.7e12 operations/s
  HBM3          3.35e12 bytes/s
  banded SW     12 int32 operations per in-band cell
  Myers         20 int32 operations per word, target column and pair

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
from typing import Callable, Dict, Sequence, Tuple

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
        raise NotImplementedError(
            "bench --what correction times both correction engines; "
            "corr_engine='sw' (the scored dirs DP) is not ported yet "
            "(ROADMAP Queue 1)")
    if what in ("scaling", "comm"):
        raise NotImplementedError(
            f"bench --what {what} needs the multi-device paths, which are "
            "not ported yet (ROADMAP Queue 1: distribution)")
    raise ValueError(what)
