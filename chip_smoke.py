#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (hga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, 500 kb genome
    python3 chip_smoke.py --genome-len 4600000 --phase10-len 4600000 \
        --phases 014a --phase10 repeats,circular,repeats+circular
                                              # the judged quality rows

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. card facts: nvidia-smi name/power limit, torch and CUDA versions
  1. build the CUDA kernels from hga_tpu_torch/csrc (one nvcc per source,
     in parallel, sm_90a), timed; registers/spills per instantiation
  k. the k-mer key kernel (kmer_keys, csrc/kmer.cu) == its plain version
     (ops/kmer._keys_plain), bit for bit, at the count's batch shape
     (65,536 reads of 7 words, k 21), at k 1, 16, 17 and 32 on pads 16,
     288 and 1,024, and on a one-read tail batch, N bases on the borders of
     packed and bad-flag words, lengths 0 to the pad; one launch a call;
     count_reads(device="cuda") of a 60 kb read set == the CPU's, field
     for field, one launch a batch; then the kernel's time (launches
     queued behind a sleep), the wrapper's, the plain version's and the
     byte bound at the count's shape
  2. K1' (myers_batch_cuda) == its plain PyTorch version, bit-exact, through
     the wrapper and in the other design (G 1 or group_width(W)), at the
     long-overlap shape (N 4096, Lq 414, Lt 478), the config-3 gate shape
     (N 4096, Lq 112, Lt 184, ragged, code-4 padding) and at W 1, 2, 4, 5,
     14, 16, 24 with qlen 0, 1, 31, 32, 62, Lq - 1, ragged tlen and codes
     -1, 4, 9; at W 25, 26, 32-34 (N 4096, Lt = Lq + 72, the split design
     alone, two words a lane at 33-34) with qlen 0, 1, 744, 745, 775, 992,
     993, 1023, 1024 (the wide route forced at W 26 and 34); on the wide
     route (myers_batch_cuda_wide must move) at W 35, 48, 64, 65 (its words
     also in the device scratch) and 100 with qlen 0, 1, 31, 31 W - 1,
     31 W, and at the long reads' gate shapes (N 128, Lq 8,192; N 64,
     Lq 31,000, held after phase 3 against its plain version, which runs
     in a process of its own on the card beside phases 2 and 3, as do
     phase 7's Lq 31,000 cases); then K1''s shared-target mode (one
     target row for every pair, counted as myers_batch_cuda_shared;
     target windows by shape)
     at segment_identity's shape (segments of 384, W 13, against genome .
     sentinel . revcomp of a 4 kb genome: Lt 8001) and at W 4, W 1, W 26,
     W 34 and W 40 (the wide route) with qlen 0, 1, 31, 32 and target
     codes -1, 4, 9, each also at forced windows of one halo and at one
     window (the single sweep); and the carried-state mode at W 26, 33, 48
     (wide) and W 40 on a shared row (one chunk, 2, 3, 8 chunks, and
     forced windows of one halo over 1, 2 and 3 chunks)
  3. K2s (myers_batch_planes_cuda) == its plain version (dist, tend, Pv,
     Mv) at the correction shape (N 4096, Lq 112, Lt 184), the forced
     one-thread K2 on the same inputs, and the traceback votes made from
     each set of planes are equal; K2s at W 1, 4, 24, 25, 34, 35 and 100
     (its wide route past 34, myers_batch_planes_cuda_wide, W 35 and 100
     also with the words in the device scratch), its route's counter
     moving by one; then K2'
     (myers_votes_cuda: DP, gate, traceback and votes in one launch) ==
     its plain version (dist, tend and the vote buffer less its sink) at
     the correction shape (min_identity 0.9, weighted and unweighted, qlen
     0, 1, 31, 62 and multiples of 10, target codes -1 and 9, ragged tlen),
     at W 1, 2, 11 (300 bp reads), 17 and 24 and at copy arbitration's
     shape (Lq 400, W 13, Lt 472), each on the home its shape takes (the
     device scratch from W 11: shared memory would hold fewer than 4
     blocks an SM), W 13 and 17 also forced into shared memory, band 960 and
     the correction shape on the scratch, at W 26, 32, 33 and 34 (pads
     800, 992, 1023, 1024, the scratch by shape), and on the wide route
     (myers_votes_cuda_wide) at W 35, 48, 64, 65 and 100, W 65 also cut
     into 4 sub-batches by a small scratch budget; each route's counter
     must move
  4. the port's main path, run_pipeline(device="cuda") with the judged
     config (copy arbitration on), on a simulated genome with the judged
     read model, through hga_tpu_torch.exp.scale_run (simulate,
     judged_cfg, run, scale_metrics); K1' and K2''s launch counters must
     move, K2' also during the arbitrate stage, and K2's stay 0; per-stage
     seconds, the arbitrate split, split_reconciliation (a WARNING fails),
     contigs, N50, k-mer identity (>= 0.99, utils/evalx) and genome
     fraction
  5. the same pipeline on a ~20 kb genome on cuda and on cpu: artifacts
     byte-identical / array-equal (arbitrated.fasta included)
  6. CUDA-event times of each kernel (wrapper and kernel alone) and of its
     plain version, GCUPS, bounds and the share of them, registers: K1' in
     both designs at W 14, 4, 5 and 1 and the split design at W 26, 32 and
     34, its wide route at N 4096 and Lq 31,000, 8,192, 3,100 and 1,085
     (and the register route beside it at W 34),
     K2s at bench_corr_tb's shape (N 4096, Lq 112, W 4) beside the forced
     K2 on the same inputs, at W 13, 26, 34 and on its wide route at W 100
     (N 1,024), K3' at the refine's shapes
     beside K3'' and K3's kernels on the same inputs, K3'' at the 300 bp
     refine's shapes (Lq 320, forward band 64 and reverse band 128) with
     its in-band share, K and shared memory, beside the K3''' and K3
     kernels on the same inputs (K3's row, forced there), K3''' at the 300
     bp refine with --band 128 (reverse band 256), at band 960 (Lq 320)
     and at Lq 31,000 (bands 64 and 128, N 4096), with the warps an SM
     holds; K2' on real correction batches
     (_prep's output) on both plane homes, its shared memory and blocks an
     SM, and on planted batches at W 26 (the scratch) and W 100 (the wide
     route); K2''s two homes at
     W 13 (arbitration), 11, 17, 20, 22, 24 and 26 (band 64), kernel alone, with
     the blocks an SM shared memory holds (votes_route's cutoff); and the
     correction batch split (_prep / K2')
  7. banded_sw_batch_cuda == its plain version, bit-exact, every case
     through the wrapper, whose route counter must move (and K3's row
     counter stay 0: no shape takes it): K3' at the
     refine's forward (N 4096, Lq 112, Lt 184, band 64) and reverse (band
     128, ragged) shapes (and K3'' forced on both) and at Lq 1, 31, 32, 33,
     112, 128, 129, 256 at bands 0, 64, 128, >= Lq; K3'' at the 300 bp
     refine's forward (N 4096, Lq 320, Lt 392, band 64) and reverse (band
     128, ragged) shapes, at Lq 257, 320, 1024 at bands 0, 1, 64, 127, 128,
     at bands 31, 32, 63, 64, 255 (K's edges) and at Lq 1024 and 1100;
     K3''' at band >= Lq above Lq 256, band 960, Lq 31,000 at bands 64 and
     128 (N 8) and band 2500 (its slots in shared memory, and forced into
     the device scratch), and forced at the 300 bp refine's shapes; K3
     (rows) forced at band >= Lq above Lq 256 and band 960 (its device
     scratch); tie rows, -1 and 4 codes, qlen/tlen 0 everywhere
  8. judged config 3, compute_overlaps_cross(device="cuda") with the SW
     refine, on the judged read model of a 400 kb genome (phase 4's seed):
     K1' and K3' counters must move, K3''
     and K3 stay 0, truth precision >= 0.95; then 300 bp reads on a 100
     kb genome, whose refine width takes K3'' (K3', K3''' and K3 stay 0);
     then those reads at --band 128, whose reverse pass (band 256) takes
     K3''' (K3'' and K3''' move, K3's rows stay 0), and on a 20 kb genome
     on cuda and on cpu, the records byte-identical
  9. the measurement path: X1 (exp/myers_micro run_b) at the harness's
     shapes and at W 1, 5, 13, 25, 34, 100 (four words a lane) and 300
     (the words in the device scratch) with ragged lengths, partial blocks
     and slabs, at two (S, BLK); X2 (exp/sw_variants v1, v2, v3, v3g2) at
     check()'s shape, the refine's, band >= Lq (the query layout), and past
     the old caps, Lq 1,000 at band 64 and Lq 320 at band 300 (v3g8 and
     v3g64 too: the slots in memory); X3 (exp/vpu_micro): each == its
     plain version, bit-exact; then the three harnesses' main() as a user
     runs them (their counters must move), the SASS add/max count of X3
     and X2's instruction mix by route, and `hga-torch bench --what
     sw|myers|count|pipeline --pairs 8192` through cli.main (the K1' and
     K3' counters must move); then the X rows' times, X1 also at W 1, 13,
     34, 100, S 1 and 2 and N 8192 beside K1', X2 also at Lq 1,000 and Lq
     320 at band 300 beside K3's route
  a. (phase 10) the pipeline on a repeat-bearing genome (sim.repeat_genome)
     with circular reads, through hga_tpu_torch.exp.scale_run as its
     --repeats --circular runs it: contigs, circular contigs, k-mer
     identity judged as a circle (>= 0.99), genome fraction, then
     utils/evalx.segment_identity on the card
     (K1''s shared-target counter must move); --phase10 picks the genomes
     (repeats, circular, repeats+circular), --phase10-len their length
     (400 kb by default)

  c. distribution (parallel/): K1''s carried-state mode
     (myers_cols_cuda, counted as myers_batch_cuda_carry) == ops/myers
     .myers_cols bit-exact at segment_identity's shape (W 13, shared row)
     and the long-overlap shape (W 14, per-pair rows) with qlen 0, 1, 31,
     32, ragged tlen and codes -1, 4, 9, and chained over 2, 3 and 8 chunks
     == one chunk == one-shot K1', windows by shape and forced windows of
     one halo (over 1, 2 and 3 chunks); then, after phase 10, two ranks sharing
     the card (gloo, parallel/launch.py): run_pipeline with phase 4's reads
     and config, its FASTA byte-identical to phase 4's, corrected.npz and
     overlaps.npz array-equal, spectrum.npz's histogram, threshold and
     solid set equal, WORK split per block_range, K1' and K2' moving on
     both ranks (K2' in the arbitrate stage); segment_identity of the
     contigs through the ring on the 2 ranks == one rank (the carried-state
     counter must move on both); `torchrun --nproc-per-node 1 -m
     hga_tpu_torch.cli eval --segs` on NCCL, the same segment_dist; `bench
     --what scaling` on 1 (NCCL) and 2 (gloo) ranks and `--what comm`

  d. the exp/ scripts of hga_tpu_torch.exp as a user runs them, on a copy
     of phase 4's run directory: bench_corr_tb (K2s and K2' must move; the
     vote buffers of the K2s planes' traceback, fused_full_S and
     fused_bounded equal on planted pairs; the three times), reoverlap
     --polish (K1' must move; overlaps.npz and contigs.fasta equal phase
     4's), polish_retry 2 passes over reoverlap's contigs (K2' must move,
     identity >= 0.99 after each pass), count_scale at 200 kb on the card
     against --device cpu (distinct k-mers, threshold and reads equal),
     diag_false_ov, diag_graph and asm_sweep (nine variants, base's contig
     count == reoverlap's); then on a 100 kb sim.repeat_genome:
     diag_repeat_corr (K2' must move), diag_leak, a scale_run --repeats
     and diag_polish_votes on its contig (K2' must move).  scale_run,
     count_scale --device cpu, asm_sweep and diag_leak run as `python -m`
     in processes of their own beside the others, which run in this
     process through main() with the command's arguments

  b. the native FASTQ reader: phase 4's reads written as FASTQ (the long
     reads also as .fastq.gz), load_reads on the native route against its
     Python reader (array-equal; seconds and reads/s); the scored-SW
     correction engine (corr_engine="sw", plain torch): correct_long_reads
     on an 8 kb genome and the 20 kb hybrid pipeline on cuda and on cpu,
     byte-identical (K1' must move, K2' must not); `hga-torch bench --what
     correction --pairs 4096` (both engines; K2' must move); `hga-torch
     correct --profile DIR` (the trace must hold K2''s kernel events; the
     device busy share of the traced window); `count` and its spectrum.png

  e. short reads past 24 Myers words: the hybrid pipeline on a 100 kb
     genome with 780-base short reads (pad 800, W 26, 30x, 1% error) and
     the judged long-read model (K2' must move in correction and in
     polish, K1' must move; identity >= 0.99); config 3's overlaps and the
     short-read-only pipeline on those reads (Myers refine: K1' moves at W
     26); at 20 kb (short reads at 12x) the hybrid pipeline, config 3 and
     the short-read-only pipeline at pad 800 and the short-read-only
     pipeline at pad 1024 (W 34: K1' and K2' on the scratch move) on cuda
     and on cpu, artifacts byte-identical; `hga-torch overlap --long`
     through cli.main on the first 10 judged long reads of a 20 kb genome
     (phase 4's seed; pad ~20 kb, W ~645: K1''s wide route must move) and
     correct_long_reads at 20 kb with 1,100-base short reads padded to
     1,120 (W 37: K2''s wide route must move) on cuda and on cpu,
     overlaps.npz and the PAF, corrected.npz byte-identical;
     hga_tpu_torch.bench.main()
     (bench.py's keys; K1' and K3' move); graft_entry.entry() == K3''s
     plain version, bit-exact, and dryrun_multichip(1), a world of one on
     NCCL

Phase 5 also runs config 3 (100 bp and 300 bp reads) and the
short-read-only pipeline (8 kb genome) on cuda and on cpu, byte-identical.
Phases run in the order 0 1 k 2 3 7 c(kernel) 4 8 a c b d 5 e 6 9 (phases c
and d run phase 4 when it is not asked for; phase c's CLI runs beside
phases b and d).  The CPU side of the card == CPU runs of phases 5, 8, b
and e runs in processes of its own (TWIN_THREADS) at the lowest priority
(nice 19) on 3/8 of the CPUs, started after phase 1, beside the phases on
the card until it ends; phase 5 and phase e hold their runs against them.
Each line of the log starts with the seconds since the script started.
Phase 6 also times K2' at the arbitration shape, K1''s shared-target mode
at segment_identity's shape and its carried-state mode at the ring's step
shape on 2 ranks, each at its windows by shape, at twice as many and at
one window (the single sweep).

The last three lines of standard output are the `kernels` JSON line, the
card's `name, power.limit`, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel (its wrapper's launch counter) -> (source, TPU kernel it replaces)
KERNELS = {
    "myers_batch_cuda": ("hga_tpu_torch/csrc/myers_gate.cu",
                         "hga_tpu/ops/myers_pallas.py:47"),
    "myers_batch_cuda_wide": ("hga_tpu_torch/csrc/myers_gate.cu",
                              "hga_tpu/ops/myers_pallas.py:47"),
    "myers_batch_cuda_shared": ("hga_tpu_torch/csrc/myers_gate.cu",
                                "hga_tpu/ops/myers_pallas.py:47"),
    "myers_batch_cuda_carry": ("hga_tpu_torch/csrc/myers_gate.cu",
                               "hga_tpu/ops/myers_pallas.py:47"),
    "myers_votes_cuda": ("hga_tpu_torch/csrc/myers_votes.cu",
                         "hga_tpu/ops/myers_pallas.py:106"),
    "myers_votes_cuda_scratch": ("hga_tpu_torch/csrc/myers_votes.cu",
                                 "hga_tpu/ops/myers_pallas.py:106"),
    "myers_votes_cuda_wide": ("hga_tpu_torch/csrc/myers_votes.cu",
                              "hga_tpu/ops/myers_pallas.py:106"),
    "myers_batch_planes_cuda": ("hga_tpu_torch/csrc/myers.cu",
                                "hga_tpu/ops/myers_pallas.py:106"),
    "myers_batch_planes_cuda_wide": ("hga_tpu_torch/csrc/myers.cu",
                                     "hga_tpu/ops/myers_pallas.py:106"),
    # K2, one thread a pair: forced only, beside K2s on the same inputs
    "myers_batch_planes_cuda_thread": ("hga_tpu_torch/csrc/myers.cu",
                                       "hga_tpu/ops/myers_pallas.py:106"),
    "banded_sw_batch_cuda": ("hga_tpu_torch/csrc/sw.cu",
                             "hga_tpu/ops/align_pallas.py:66"),
    "banded_sw_batch_cuda_band": ("hga_tpu_torch/csrc/sw.cu",
                                  "hga_tpu/ops/align_pallas.py:66"),
    "banded_sw_batch_cuda_wide": ("hga_tpu_torch/csrc/sw.cu",
                                  "hga_tpu/ops/align_pallas.py:66"),
    "banded_sw_batch_cuda_rows": ("hga_tpu_torch/csrc/sw.cu",
                                  "hga_tpu/ops/align_pallas.py:66"),
    "run_b_cuda": ("hga_tpu_torch/csrc/myers_micro.cu",
                   "exp/myers_micro.py:58"),
    "sw_variants_v1": ("hga_tpu_torch/csrc/sw_variants.cu",
                       "exp/sw_variants.py:32"),
    "sw_variants_v2": ("hga_tpu_torch/csrc/sw_variants.cu",
                       "exp/sw_variants.py:95"),
    "sw_variants_v3": ("hga_tpu_torch/csrc/sw_variants.cu",
                       "exp/sw_variants.py:326"),
    "vpu_chains_cuda": ("hga_tpu_torch/csrc/vpu_micro.cu",
                        "exp/vpu_micro.py:16"),
    # no TPU kernel: the JAX package's extraction is plain jnp
    "kmer_keys": ("hga_tpu_torch/csrc/kmer.cu",
                  "none (hga_tpu/ops/kmer.py extract_kmers is plain jnp)"),
}


_T0 = time.perf_counter()
_T0_WALL = time.time()


def log(msg: str) -> None:
    """One line of the smoke's log, after the seconds since it started."""
    print(f"{time.perf_counter() - _T0:7.1f} {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


_PTXAS_ENTRY = (
    # (kind, mangled-name pattern, key of the instantiation from its groups)
    ("K1'", r"myers_gate_kernelILi(\d+)ELi(\d+)E",
     lambda g: f"W{g[0]}G{g[1]}"),
    ("K2", r"myers_kernelILi(\d+)E", lambda g: int(g[0])),
    ("K2s", r"myers_planes_kernelILi(\d+)ELi(\d+)E",
     lambda g: f"W{g[0]}G{g[1]}"),
    ("K2'", r"myers_votes_kernelILi(\d+)ELi(\d+)ELb([01])E",
     lambda g: f"G{g[0]}WL{g[1]}{'smem' if g[2] == '1' else 'scratch'}"),
    ("K3'", r"sw_diag_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
    ("K3''", r"sw_band_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
    ("K3'''", r"sw_wide_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
    ("K3'''", r"sw_wide_mem_kernelILb([01])E",
     lambda g: "mem_scratch" if g[0] == "1" else "mem_smem"),
    ("K3", r"sw_kernelILb([01])E",
     lambda g: "smem" if g[0] == "1" else "scratch"),
    ("X1", r"myers_slab_kernelILi(\d+)E", lambda g: f"WL{g[0]}"),
    ("X2", r"swv_kernelILi(\d+)ELi(\d+)E", lambda g: f"K{g[0]}f{g[1]}"),
    ("X2", r"swv_packed_kernelILi(\d+)E", lambda g: f"v2H{g[0]}"),
    ("X2", r"swv_mem_kernel", lambda g: "memory"),
    ("X3", r"vpu_kernelILi(\d+)ELi(\d+)E", lambda g: f"C{g[0]}S{g[1]}"),
    ("kmer", r"kmer_keys_kernelILi(\d+)E", lambda g: f"V{g[0]}"),
)


def ptxas_report(text: str):
    """(kernel, instantiation, registers, (spill store bytes, spill load
    bytes)) per instantiation, from nvcc's -Xptxas -v report: K1' by W and
    lanes a pair, K2 by W, K2s by W and lanes a pair, K2' by lanes a pair,
    words a lane and plane home, K3', K3'' and K3''' by slots a lane (and
    K3''''s slots in memory), K3 by buffer kind, X1 by words a lane (WL0:
    the words in the device scratch), X2 by route (int32 K slots a lane and
    ablation flags, v2's H packed words a lane, the slots in memory), X3 by
    C and STEPS."""
    import re

    rows, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = None
            for kind, pat, key in _PTXAS_ENTRY:
                m = re.search(r"Compiling entry function '.*?" + pat, line)
                if m:
                    cur = [kind, key(m.groups()), 0, (0, 0)]
                if cur is not None:
                    rows.append(cur)
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur[3] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur[2] = int(m.group(1))
    return sorted((tuple(r) for r in rows),
                  key=lambda r: (r[0], str(r[1]).zfill(8)))


def eq(name, a, b) -> int:
    """Exact equality of two tensors; returns max |a - b| (0)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        fail(f"{name}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    if not torch.equal(a, b):
        bad = int((a != b).sum())
        fail(f"{name}: {bad}/{a.numel()} values differ")
    log(f"  ok: {name} ({a.numel()} values equal)")
    return 0


# ---------------------------------------------------------------- inputs

def planted_pairs(rng, N, Lq, Lt, lead=16):
    """Targets = a mutated copy (5% subs, 5% query-base deletions) of the
    query between random flanks, so alignments take diag/up/left moves."""
    import numpy as np

    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    ins = rng.random((N, Lq)) < 0.05
    sub = rng.random((N, Lq)) < 0.05
    mut = np.where(sub, (q + 1 + rng.integers(0, 3, q.shape)) % 4, q)
    for i in range(N):
        seg = mut[i][~ins[i]]
        t[i, lead:lead + seg.size] = seg[:Lt - lead]
    ql = np.full(N, Lq, np.int32)
    ql[: N // 8] = rng.integers(1, max(Lq, 2), N // 8)   # ragged lengths
    tl = np.full(N, Lt, np.int32)
    return q, t, ql, tl


def k2v_launches(launches: dict) -> int:
    """K2''s launches on both plane homes (copy arbitration's chunks, W 13,
    take the device scratch by shape, correction at W 4 shared memory)."""
    return launches.get("myers_votes_cuda", 0) + \
        launches.get("myers_votes_cuda_scratch", 0)


def moved(before: dict, now: dict) -> dict:
    """The launch counters that moved from `before` to `now`, by how
    much."""
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def launch_counts() -> dict:
    """The registry's launch counters (hga_tpu_torch/utils/spans), by
    route; a route never launched reads 0."""
    from hga_tpu_torch.utils import spans

    return spans.launches()


def zero_launches() -> None:
    """Drop every launch counter of the registry (each reads 0 again)."""
    from hga_tpu_torch.utils import spans

    spans.reset(spans.LAUNCH)


def restore(before: dict) -> None:
    """Take back the launches counted since `before` (launch_counts()):
    a timing loop's launches are no path's."""
    from hga_tpu_torch.utils import spans

    for k, v in (launch_counts() - before).items():
        spans.count(spans.LAUNCH + k, -v)


def to_dev(*xs):
    import torch

    return tuple(torch.from_numpy(x).cuda() for x in xs)


def gate_inputs(rng):
    """The config-3 gate's K1 launch (models/overlap._myers_gate): N 4096
    short-read segments (Lq 112, W 4) of ragged length padded with code 4,
    windows of Lq + band + 8 = 184 that run off the long read's ends (code
    4), every tlen the full window."""
    import numpy as np

    N, Lq, Lt = 4096, 112, 184
    q, t, _, tl = planted_pairs(rng, N, Lq, Lt, lead=32)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:4] = [0, 31, 32, Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    row, x = np.arange(N), np.arange(Lt)[None, :]
    pre = np.where(row < N // 4, rng.integers(0, Lt // 2, N), 0)
    post = np.where((row >= N // 4) & (row < N // 2),
                    rng.integers(0, Lt // 2, N), 0)
    t[(x < pre[:, None]) | (x >= Lt - post[:, None])] = 4
    return q, t, ql, tl


# ---------------------------------------------------------------- phases

def kmer_inputs(rng, R: int, pad: int):
    """A batch of R reads padded to `pad` as count_reads ships it: random
    packed words, N flags on the borders of packed (16) and bad-flag (32)
    words in every third read and at random elsewhere, lengths from 0 to
    the pad (most of them pad - 12, as 100 bp reads padded to 112)."""
    import numpy as np

    packed = rng.integers(0, 2**32, (R, pad // 16),
                          dtype=np.uint64).astype(np.uint32)
    bad = np.zeros((R, -(-pad // 32)), np.uint32)
    for b in (15, 16, 31, 32, 47, 48, 63, 64):
        if b < pad:
            rows = np.arange(0, R, 3)[rng.random(-(-R // 3)) < 0.5]
            bad[rows, b >> 5] |= np.uint32(1 << (b & 31))
    r, p = np.nonzero(rng.random((R, pad)) < 0.002)
    np.bitwise_or.at(bad, (r, p >> 5), (np.uint32(1) << (p & 31).astype(
        np.uint32)))
    length = np.full(R, max(0, pad - 12), np.int32)
    ragged = rng.random(R) < 0.25
    length[ragged] = rng.integers(0, pad + 1, int(ragged.sum()))
    return packed.view(np.int32), bad.view(np.int32), length


def queued_ms(fn, sets, reps: int = 50) -> float:
    """Device ms a call of `fn`, its launches queued behind a sleep on the
    stream so that the host's launch cost does not pace them (CUDA
    events)."""
    import torch

    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    s.record()
    for r in range(reps):
        fn(*sets[r % len(sets)])
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def phase_kmer(rng):
    """Phase k: the k-mer key kernel against its plain version, its launch
    count, count_reads on the card against the CPU, then its times.
    Returns (max error, launches by path, the kernel's row)."""
    import numpy as np
    import torch

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.ops import kmer as K
    from hga_tpu_torch.ops import kmer_cuda as KC
    from hga_tpu_torch.utils import benchmarks as B
    from hga_tpu_torch.utils import sim

    t0 = time.perf_counter()
    cases = [("the count's batch", 65536, 112, 21)] + [
        (f"pad {pad}, k {k}", 4099, pad, k) for pad in (16, 288, 1024)
        for k in (1, 16, 17, 32) if k <= pad] + [
        ("a one-read tail", 1, 112, 21)]
    before = launch_counts()
    for label, R, pad, k in cases:
        args = to_dev(*kmer_inputs(rng, R, pad))
        got = K.kmer_keys(*args, k)
        torch.cuda.synchronize()
        eq(f"kmer_keys {label} (R {R}, W {pad // 16}, k {k})", got,
           K._keys_plain(*args, k))
    n = (launch_counts() - before)[KC.COUNTER]
    if n != len(cases):
        fail(f"kmer_keys launched {n} times for {len(cases)} calls")

    ds = sim.make_dataset(genome_len=60_000, short_cov=20, long_cov=0,
                          seed=18, short_err=0.01)
    pr = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=112)
    cfg = AssemblerConfig(k=21, batch_reads=4096)
    before = launch_counts()
    card = count_reads(pr, cfg, device="cuda")
    path = launch_counts() - before
    cpu = count_reads(pr, cfg, device="cpu")
    batches = -(-pr.n_reads // cfg.batch_reads)
    if path[KC.COUNTER] != batches:
        fail(f"count_reads launched kmer_keys {path[KC.COUNTER]} times for "
             f"{batches} batches")
    for f in ("hi", "lo", "count", "hist"):
        if not np.array_equal(getattr(card, f), getattr(cpu, f)):
            fail(f"count_reads on the card: {f} differs from the CPU's")
    if (card.threshold, card.n_distinct) != (cpu.threshold, cpu.n_distinct):
        fail("count_reads on the card: threshold or distinct total differs")
    log(f"  ok: count_reads card == CPU ({pr.n_reads} reads, {batches} "
        f"batches, {card.n_distinct} distinct, {card.hi.size} solid)")

    R, W, k = 65536, 7, 21
    sets = [to_dev(*kmer_inputs(rng, R, 16 * W)) for _ in range(4)]
    before = launch_counts()
    kern_ms = queued_ms(lambda *a: KC.kmer_keys_cuda(*a, k), sets)
    ms = B.cuda_ms(lambda *a: K.kmer_keys(*a, k), sets, 20)
    plain_ms = one_call_ms(lambda *a: K._keys_plain(*a, k), sets[0])
    restore(before)
    m = 16 * W - k + 1
    nbytes = sum(x.numel() * 4 for x in sets[0]) + 8 * R * m
    bound, by = B.bound_ms(0, nbytes)
    g = KC.geometry(R, W, k)
    regs, local = KC.kernel_attrs(g.vec)
    row = dict(shape=f"R {R}, W {W}, k {k} ({g.rows} reads a tile, "
                     f"{g.vec} slots a thread, {g.tiles} blocks, {g.smem} "
                     "B shared)",
               ms=ms, kernel_ms=kern_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, pct_of_bound=100 * bound / kern_ms,
               registers=regs, local_bytes=local)
    log(f"  kmer_keys at the count's batch: kernel {kern_ms:.4f} ms, "
        f"wrapper {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} "
        f"ms ({by}), {row['pct_of_bound']:.1f}% of it; {regs} registers, "
        f"{local} B local")
    log(f"  phase k: {time.perf_counter() - t0:.1f} s")
    return 0, {"phase k count_reads": dict(path)}, row

def myers_edges(rng, N, Lq, Lt, edges=(0, 1, 31, 32, 62)):
    """Planted pairs with K1's edge cases: qlen `edges` and Lq - 1 (those
    that fit), code 4 past qlen, ragged tlen, codes -1, 4 and 9 in queries
    and targets."""
    import numpy as np

    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt)
    edge = [x for x in (*edges, Lq - 1) if x <= Lq]
    ql[:len(edge)] = edge
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl[N // 2:] = rng.integers(0, Lt + 1, N - N // 2)   # ragged targets
    t[8:72, :8] = rng.choice([-1, 4, 9], size=t[8:72, :8].shape)
    q[72:136, :6] = rng.choice([-1, 4, 9], size=q[72:136, :6].shape)
    t[9, Lt // 4:Lt // 2] = 4
    return q, t, ql, tl


def segment_inputs(rng, genome_len: int, n_extra: int = 8, seg: int = 384):
    """segment_identity's operands on a random genome (the row: genome .
    sentinel . reverse complement): the segments of a copy of the genome
    with 1% substitutions, its first half forward and its second half
    reverse complemented, and `n_extra` random segments (no placement);
    the last segment of each half is short; tlen is the whole row.
    Returns int32 (q, t (1, Lt), qlen, tlen)."""
    import numpy as np

    # the shared row, as utils/evalx.segment_identity builds it
    g = rng.integers(0, 4, genome_len)
    row = np.full(2 * genome_len + 1, 4, np.int32)
    row[:genome_len] = g
    row[genome_len + 1:] = 3 - g[::-1]
    qs, ql = [], []
    half = genome_len // 2
    for copy in (g[:half], 3 - g[half:][::-1]):
        c = np.where(rng.random(copy.size) < 0.01, (copy + 1) % 4, copy)
        for o in range(0, c.size, seg):
            piece = c[o:o + seg]
            qs.append(np.pad(piece, (0, seg - piece.size),
                             constant_values=4))
            ql.append(piece.size)
    for _ in range(n_extra):
        qs.append(rng.integers(0, 4, seg))
        ql.append(seg)
    q = np.stack(qs).astype(np.int32)
    ql = np.array(ql, np.int32)
    tl = np.full(q.shape[0], row.size, np.int32)
    return q, row[None, :], ql, tl


def shared_edges(rng, N, Lq, Lt):
    """The shared-target mode's edges: queries copied from the row with a
    few substitutions, and random ones; qlen 0, 1, 31, 32, Lq; code 4 past
    qlen; a sentinel column and codes -1, 4, 9 in the row; ragged tlen."""
    import numpy as np

    t = rng.integers(0, 4, (1, Lt)).astype(np.int32)
    t[0, Lt // 2] = 4
    t[0, 5:9] = [-1, 4, 9, 9]
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    for n in range(0, N, 2):
        off = int(rng.integers(0, Lt - Lq))
        q[n] = t[0, off:off + Lq] % 4
        q[n, rng.integers(0, Lq, 3)] = rng.integers(0, 4, 3)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:5] = [0, 1, min(31, Lq), min(32, Lq), Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = np.full(N, Lt, np.int32)
    tl[N // 2:] = rng.integers(0, Lt + 1, N - N // 2)
    return q, t, ql, tl


def window_cases(M, W: int, Lt: int):
    """K1''s forced windows at one shape: the smallest legal window (one
    halo) where it splits the target, and one window (the single sweep)."""
    H = M.window_halo(W)
    return ([H] if Lt > H else []) + [max(Lt, 1)]


def phase_k1_shared(rng, MC, M):
    """K1''s shared-target mode through its wrapper (its own counter must
    move; windows by shape) and, kernel alone, in the other design and at
    forced windows (one halo, and one window: the single sweep), against
    the one-sweep plain version on the same (1, Lt) row; the wide route at
    W 40."""
    import torch

    errs = []
    cases = [("shared target, segment_identity shape (4 kb genome: "
              "Lq 384, W 13, Lt 8001)", segment_inputs(rng, 4_000)),
             ("shared target W 4 (N 1000, Lq 112, Lt 3000)",
              shared_edges(rng, 1000, 112, 3000)),
             ("shared target W 1 (N 300, Lq 20, Lt 1000)",
              shared_edges(rng, 300, 20, 1000)),
             ("shared target W 26 (N 1000, Lq 800, Lt 3000)",
              shared_edges(rng, 1000, 800, 3000)),
             ("shared target W 34 (N 500, Lq 1024, Lt 3000)",
              shared_edges(rng, 500, 1024, 3000)),
             ("shared target W 40, wide route (N 200, Lq 1240, Lt 6000)",
              shared_edges(rng, 200, 1240, 6000))]
    for label, x in cases:
        args = to_dev(*x)
        t0 = time.perf_counter()
        ref = M.myers_batch(*args)
        torch.cuda.synchronize()
        log(f"  plain version ({label}): {time.perf_counter() - t0:.1f} s")
        W, Lt = M.n_words(x[0].shape[1]), x[1].shape[1]
        before = launch_counts()["myers_batch_cuda_shared"]
        got = MC.myers_batch_cuda(*args)
        if launch_counts()["myers_batch_cuda_shared"] != before + 1:
            fail(f"K1' {label}: myers_batch_cuda_shared did not count")
        r = MC.kernel_operands(*args)[4]
        errs += [eq(f"K1' {label} G {r.G} S {r.S} {f}", getattr(got, f),
                    getattr(ref, f)) for f in ("dist", "tend")]
        runs = [(f"G {g} S by shape", dict(group=g))
                for g in set(MC.gate_designs(W)) - {r.G}]
        runs += [(f"window {w}", dict(window=w))
                 for w in window_cases(M, W, Lt)]
        for tag, kw in runs:
            *ops, outs = MC.kernel_operands(*args, **kw)
            MC.run_kernel(*ops, outs)
            errs += [eq(f"K1' {label} {tag} (S {ops[4].S}) {f}", o,
                        getattr(ref, f))
                     for f, o in zip(("dist", "tend"), outs)]
    return max(errs)


def phase_k1(rng, MC, M):
    """K1' through its wrapper (GATE_GROUP's lanes a pair, the wide route
    past 34 words, whose counter must move) and through the other design at
    each shape, against the plain version (the longest gate case,
    phase_gate_long, runs after phase 3)."""
    import torch

    log("phase 2: K1' myers_batch_cuda vs plain, bit-exact, both designs and "
        "the wide route")
    errs = {"myers_batch_cuda": [], "myers_batch_cuda_wide": []}
    cases = [("long-overlap shape (N 4096, Lq 414, Lt 478)",
              myers_edges(rng, 4096, 414, 478)),
             ("config-3 gate shape (N 4096, Lq 112, Lt 184)",
              gate_inputs(rng))]
    for n, lq, lt in ((1024, 20, 64), (1024, 40, 96), (1024, 112, 184),
                      (1024, 128, 192), (1024, 414, 478), (512, 480, 540),
                      (512, 24 * 31, 800)):        # W 1, 2, 4, 5, 14, 16, 24
        cases.append((f"W {M.n_words(lq)} (N {n}, Lq {lq}, Lt {lt})",
                      myers_edges(rng, n, lq, lt)))
    # W 25-34 (the split design alone; two words a lane at 33-34): 745-1054
    # bases, Lt = Lq + 72
    for lq in (775, 800, 992, 1023, 1024):         # W 25, 26, 32-34
        cases.append((f"W {M.n_words(lq)} (N 4096, Lq {lq}, Lt {lq + 72})",
                      myers_edges(rng, 4096, lq, lq + 72,
                                  edges=(0, 1, 744, 745, 775, 992, 993,
                                         1023, 1024))))
    # the wide route: W 35, 48, 64, 65, 100 (Lq 31 W), then long-read gate
    # shapes (the long reads' pad: ~8 kb, and ~31 kb as a 4.6 Mb judged run
    # pads them), N small where the plain version's column loop is slow
    for n, W in ((1024, 35), (1024, 48), (512, 64), (512, 65), (256, 100)):
        lq = 31 * W
        cases.append((f"W {W} (N {n}, Lq {lq}, Lt {lq + 72})",
                      myers_edges(rng, n, lq, lq + 72,
                                  edges=(0, 1, 31, lq - 1, lq))))
    cases.append(("long-read gate W 265 (N 128, Lq 8192, Lt 8264)",
                  myers_edges(rng, 128, 8192, 8264)))
    for label, x in cases:
        args = to_dev(*x)
        t0 = time.perf_counter()
        ref = M.myers_batch(*args)
        torch.cuda.synchronize()
        gate_check(MC, M, label, args, ref, time.perf_counter() - t0, errs)
    return {k: max(v) for k, v in errs.items()}


def phase_gate_long(MC, M, plains) -> int:
    """Phase 2's longest gate case, the long reads' pad of a 4.6 Mb judged
    run (GATE_LONG: N 64, Lq 31,000, W 1,000), held after phase 3 against
    its plain version's process (plain_procs)."""
    n, lq = GATE_LONG
    ref, dt = plain_ref(plains, "gate", M.MyersResult)
    errs = {"myers_batch_cuda": [], "myers_batch_cuda_wide": []}
    gate_check(MC, M, f"long-read gate W {M.n_words(lq)} (N {n}, Lq {lq}, "
               f"Lt {lq + 72}; plain in its process)",
               to_dev(*long_gate_case()),
               ref, dt, errs)
    return max(errs["myers_batch_cuda_wide"])


def gate_check(MC, M, label, args, ref, dt, errs) -> None:
    """One K1' case: the wrapper (its route's counter must move by one) and
    the other designs forced, each against `ref`, the plain version's
    result (`dt` seconds); the max errors join `errs` by counter."""
    W = M.n_words(args[0].shape[1])
    r = MC.kernel_operands(*args)[4]
    key = MC.gate_counter(r, False)
    before = launch_counts()[key]
    got = MC.myers_batch_cuda(*args)
    if launch_counts()[key] != before + 1:
        fail(f"K1' {label}: {key} did not count")
    if (W > MC.REGISTER_MAX_WORDS) != (key == "myers_batch_cuda_wide"):
        fail(f"K1' {label} took {key}")
    errs[key] += [eq(f"K1' {label} G {r.G} ({key}; plain {dt:.1f} s) "
                     f"{f}", getattr(got, f), getattr(ref, f))
                  for f in ("dist", "tend")]
    runs = [(f"G {g}", dict(group=g))
            for g in set(MC.gate_designs(W)) - {r.G}]
    if W in (26, 34):          # the wide route forced below its W
        runs.append(("wide route forced", dict(wide=True)))
    if W == 65:                # its words in the device scratch
        runs.append(("words in the scratch", dict(words_scratch=True)))
    for tag, kw in runs:
        *ops, outs = MC.kernel_operands(*args, **kw)
        MC.run_kernel(*ops, outs)
        errs[MC.gate_counter(ops[4], False)] += [
            eq(f"K1' {label} {tag} {f}", o, getattr(ref, f))
            for f, o in zip(("dist", "tend"), outs)]


PLANES_FIELDS = ("dist", "tend", "Pv planes", "Mv planes")


def planes_eq(label, outs, ref) -> list:
    """K2s's or K2's four outputs against the plain version's."""
    got = (outs[0].dist, outs[0].tend, outs[1], outs[2]) \
        if isinstance(outs, tuple) else outs
    want = (ref[0].dist, ref[0].tend, ref[1], ref[2])
    return [eq(f"{label} {f}", g, w)
            for f, g, w in zip(PLANES_FIELDS, got, want)]


def planes_words(rng, MC, M):
    """K2s == plain past K2's old 24-word cap and at its routes' edges: W 1,
    4, 24, 25, 34, 35 and 100 (Lq 31 W, Lt = Lq + 72; qlen 0, 1, 31,
    31 W - 1, 31 W, ragged tlen, codes -1, 4, 9; N 256, N 64 at W 100)
    through the wrapper, whose route's counter (the wide route past 34)
    must move by one, W 35 and 100 also with their words in the device
    scratch."""
    errs = {"myers_batch_planes_cuda": [], "myers_batch_planes_cuda_wide": []}
    for W in (1, 4, 24, 25, 34, 35, 100):
        N, lq = (256 if W < 100 else 64), 31 * W
        args = to_dev(*myers_edges(rng, N, lq, lq + 72,
                                   edges=(0, 1, 31, lq - 1, lq)))
        key = MC.planes_counter(MC.planes_route(lq))
        before = launch_counts()
        got = MC.myers_batch_planes_cuda(*args)
        if moved(before, launch_counts()) != {key: 1}:
            fail(f"K2s at W {W}: counters moved "
                 f"{moved(before, launch_counts())}, not {key} once")
        ref = M.myers_batch_planes(*args)
        errs[key] += planes_eq(f"K2s W {W} (N {N}, {key})", got, ref)
        if W > MC.REGISTER_MAX_WORDS:
            r, ins, outs = MC.planes_operands(*args, words_scratch=True)
            MC.run_planes_kernel(r, ins, outs)
            errs[key] += planes_eq(f"K2s W {W} words in the scratch", outs,
                                   ref)
    return {k: max(v) for k, v in errs.items()}


def phase_k2(rng, MC, M, PU):
    import torch

    log("phase 3: K2s myers_batch_planes_cuda vs plain, bit-exact (and K2 "
        "forced)")
    N, Lq, Lt = 4096, 112, 184
    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt)
    ql[:4] = [0, 31, 62, Lq - 1]
    t[8, :30] = -1
    t[9, 50:90] = 9
    args = to_dev(q, t, ql, tl)
    got, gpv, gmv = MC.myers_batch_planes_cuda(*args)
    ref, rpv, rmv = M.myers_batch_planes(*args)
    errs = planes_eq("K2s (N 4096, Lq 112, Lt 184)", (got, gpv, gmv),
                     (ref, rpv, rmv))
    r, ins, outs = MC.planes_operands(*args, thread=True)
    MC.run_planes_kernel(r, ins, outs)
    err_thread = max(planes_eq("K2 forced (N 4096, Lq 112, Lt 184)", outs,
                               (ref, rpv, rmv)))
    # traceback votes from each set of planes (the gate of correction)
    nb, lpad, slots = 8, 512, 3
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * slots * 4
    bb = torch.from_numpy(rng.integers(0, nb, N).astype("int32")).cuda()
    off = torch.from_numpy(rng.integers(0, lpad - Lt, N).astype("int32")).cuda()
    lb = torch.full((N,), lpad, dtype=torch.int32, device="cuda")
    qd, td, qld, _ = args
    max_ed = (0.25 * qld.float()).to(torch.int32)
    votes = []
    for res, pv, mv in ((got, gpv, gmv), (ref, rpv, rmv)):
        ok = (res.dist <= max_ed) & (qld > 0) & (res.tend > 0)
        m = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
        PU.accumulate_backbone_votes_myers(
            m, pv, mv, res.dist, torch.where(ok, qld, 0), res.tend, qd, td,
            bb, off, lb, size_v=size_v, lpad=lpad, ins_slots=slots,
            max_steps=Lq + int(0.25 * Lq) + 2)
        votes.append(m[:size_all])
    if int(votes[0].sum()) == 0:
        fail("traceback cast no votes")
    errs.append(eq("K2s traceback votes", votes[0], votes[1]))
    out = planes_words(rng, MC, M)
    out["myers_batch_planes_cuda"] = max(
        errs + [out["myers_batch_planes_cuda"]])
    out["myers_batch_planes_cuda_thread"] = err_thread
    return out


def votes_inputs(rng, N, Lq, band, nb=8):
    """A correction batch for K2': planted pairs in windows of Lq + band + 8
    columns, qlen 0, 1, 31, 62 (those that fit) and 32 rows of multiples of
    10, code 4 past qlen, target codes -1 and 9, ragged tlen on N / 16 rows,
    windows that start before the backbone or run past its end, weights
    1..3 (0 past qlen).  Returns the operands (numpy) and lpad."""
    import numpy as np

    Lt = Lq + band + 8
    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt, lead=band // 2)
    edge = [x for x in (0, 1, 31, 62) if x <= Lq]
    ql[:len(edge)] = edge
    ql[8:40] = 10 * rng.integers(1, Lq // 10 + 1, 32)
    pos = np.arange(Lq)[None, :]
    q[pos >= ql[:, None]] = 4
    t[40:72, 5:9] = -1
    t[72:104, 12:40:5] = 9
    tl[104:104 + N // 16] = rng.integers(0, Lt + 1, N // 16)
    lpad = max(512, -(-(Lt + 64) // 32) * 32)
    bb = rng.integers(0, nb, N).astype(np.int32)
    off = rng.integers(-16, lpad - Lt + 16, N).astype(np.int32)
    lb = rng.integers(lpad - 64, lpad + 1, N).astype(np.int32)
    qw = rng.integers(1, 4, (N, Lq)).astype(np.int32)
    qw[pos >= ql[:, None]] = 0
    return (q, t, ql, tl, bb, off, lb, qw), nb, lpad


def votes_check(label, MC, PU, ops, nb, lpad, min_identity, weighted,
                scratch=False, smem=False, budget=0):
    """K2' through its wrapper (the route by shape, whose counter must move
    by one), or forced onto the scratch route or into shared memory (where
    the shape's block fits), or cut into sub-batches by a scratch `budget`
    of bytes (at least two launches), against myers_votes on the same
    inputs: dist, tend and the vote buffer less its sink, which the kernel
    never writes."""
    import torch

    args = to_dev(*ops)
    if not weighted:
        args = args[:7] + (None,)
    Lq = ops[0].shape[1]
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * 3 * 4
    kw = dict(min_identity=min_identity, size_v=size_v, lpad=lpad,
              ins_slots=3, max_steps=Lq + int((1.0 - min_identity) * Lq) + 2)
    ref_m = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
    ref, _ = PU.myers_votes(ref_m, *args, **kw)
    got_m = torch.zeros_like(ref_m)
    if scratch or smem or budget:
        r, ins, scalars, sc, _, outs = MC.votes_operands(
            got_m, *args, scratch=scratch or smem,
            budget=budget or MC.VOTES_SCRATCH_BYTES, **kw)
        if smem:
            r = r._replace(smem=r.smem + r.pairs * r.stride * 4,
                           scratch=False)
            sc = (None, None, ins[0].shape[0])
        n = MC.run_votes_kernel(r, ins, scalars, sc, got_m, outs)
        if budget and n < 2:
            fail(f"K2' {label}: a budget of {budget} B made {n} launch")
        if budget:
            log(f"  K2' {label}: {n} launches of {sc[2]} pairs under a "
                f"scratch budget of {budget} B")
        got = MC.MyersResult(*outs)
    else:
        r = MC.votes_route(Lq, ops[1].shape[1])
        key = MC.votes_counter(r)
        before = launch_counts()[key]
        got, _ = MC.myers_votes_cuda(got_m, *args, **kw)
        if launch_counts()[key] != before + 1:
            fail(f"K2' {label}: {key} did not count its launch")
    name = (f"K2' {label} ({'wide, ' if r.wl else ''}"
            f"{'scratch' if r.scratch else 'smem'}, "
            f"{'weighted' if weighted else 'unweighted'}, min_identity "
            f"{min_identity})")
    if int(ref_m[:size_all].sum()) <= 0:
        fail(f"{name}: the plain version cast no votes")
    if int(got_m[size_all]) != 0:
        fail(f"{name}: the kernel wrote the sink slot")
    return max(eq(f"{name} dist", got.dist, ref.dist),
               eq(f"{name} tend", got.tend, ref.tend),
               eq(f"{name} votes", got_m[:size_all], ref_m[:size_all]))


def phase_k2v(rng, MC, PU):
    """K2' against myers_votes: the correction shape at min_identity 0.9
    (where only float32 gate arithmetic agrees at qlen multiples of 10),
    W 1, 2, 11, 13 (copy arbitration), 17 and 24 at min_identity 0.75 on
    the home the shape takes (W 13 and 17 also forced into the shared
    memory the route declines), band 960 and the correction shape on the scratch
    route, then W 26, 32, 33 and 34 (pads 800, 992, 1023 and 1024) on it
    by shape, and W 35-100 on the wide route (one batch cut into
    sub-batches)."""
    log("phase 3: K2' myers_votes_cuda vs plain, bit-exact")
    errs = {"myers_votes_cuda": [], "myers_votes_cuda_scratch": []}
    ops, nb, lpad = votes_inputs(rng, 4096, 112, 64)
    label = "correction shape (N 4096, Lq 112, Lt 184)"
    for weighted in (False, True):
        errs["myers_votes_cuda"].append(votes_check(
            label, MC, PU, ops, nb, lpad, 0.9, weighted))
    errs["myers_votes_cuda_scratch"].append(votes_check(
        label, MC, PU, ops, nb, lpad, 0.9, False, scratch=True))
    # W 1, 2, 11 (300 bp reads), copy arbitration's chunks (pad 400 at
    # k 15: W 13, Lt 472, 2 pairs a warp), W 17 (32 lanes a pair), W 24 and
    # band 960, each on the home its shape takes (the scratch from W 11)
    for n, lq, band in ((4096, 31, 64), (4096, 62, 64), (4096, 320, 64),
                        (4096, 400, 64), (1024, 527, 64), (512, 744, 64),
                        (128, 744, 960)):
        ops, nb, lpad = votes_inputs(rng, n, lq, band)
        r = MC.votes_route(lq, lq + band + 8)
        label = f"W {r.W} (N {n}, Lq {lq}, Lt {lq + band + 8})"
        for weighted in (False, True):
            errs[MC.votes_counter(r)].append(votes_check(
                label, MC, PU, ops, nb, lpad, 0.75, weighted))
        if lq in (400, 527):
            # the shared-memory home the route declines (G 16 and 32)
            errs["myers_votes_cuda"].append(votes_check(
                label, MC, PU, ops, nb, lpad, 0.75, True, smem=True))
    if not MC.votes_route(744, 744 + 968).scratch:
        fail("band 960 did not take K2''s scratch route")
    # short reads padded to 800 (W 26), 992 (W 32), 1023 and 1024 (W 33
    # and 34: two words a lane) at the correction band, on the scratch by
    # shape
    for n, lq in ((2048, 800), (2048, 992), (1024, 1023), (1024, 1024)):
        ops, nb, lpad = votes_inputs(rng, n, lq, 64)
        r = MC.votes_route(lq, lq + 72)
        if not r.scratch:
            fail(f"K2' at W {r.W} did not take the scratch route")
        for weighted in (False, True):
            errs[MC.votes_counter(r)].append(votes_check(
                f"W {r.W} (N {n}, Lq {lq}, Lt {lq + 72})", MC, PU, ops, nb,
                lpad, 0.75, weighted))
    # the wide route: W 35, 48, 64, 65 and 100 (pads 1085 .. 3100) at the
    # correction band, through the wrapper (weighted, and at W 35
    # unweighted too); at W 65 the batch forced into 4 sub-batches by a
    # small scratch budget, the same votes
    errs["myers_votes_cuda_wide"] = []
    for n, W in ((1024, 35), (512, 48), (512, 64), (512, 65), (256, 100)):
        lq = 31 * W
        ops, nb, lpad = votes_inputs(rng, n, lq, 64)
        r = MC.votes_route(lq, lq + 72)
        if MC.votes_counter(r) != "myers_votes_cuda_wide":
            fail(f"K2' at W {W} took {MC.votes_counter(r)}")
        label = f"W {W} (N {n}, Lq {lq}, Lt {lq + 72})"
        if W == 65:
            errs["myers_votes_cuda_wide"].append(votes_check(
                label, MC, PU, ops, nb, lpad, 0.75, True,
                budget=-(-n // 4) * MC.votes_scratch_bytes(r)))
            continue
        for weighted in ((False, True) if W == 35 else (True,)):
            errs["myers_votes_cuda_wide"].append(votes_check(
                label, MC, PU, ops, nb, lpad, 0.75, weighted))
    return {k: max(v) for k, v in errs.items()}


def reversed_prefixes(q, t, qend, tend):
    """The refine's reverse-pass operands (models/overlap.py): row i holds
    q[:qend] and t[:tend] reversed, code 4 past them."""
    import numpy as np

    def rev(x, n):
        idx = (n[:, None] - 1) - np.arange(x.shape[1])[None, :]
        return np.where(idx >= 0, np.take_along_axis(
            x, np.clip(idx, 0, x.shape[1] - 1), 1), 4).astype(np.int32)

    return rev(q, qend), rev(t, tend), qend.astype(np.int32), \
        tend.astype(np.int32)


def sw_edges(rng, n, lq, lt, band):
    """Planted pairs with K3's edge cases: qlen and tlen 0 and full, ragged
    lengths, a sentinel row, -1 codes in queries and targets, homopolymers
    and ACAC... repeats (ties on many cells and slots)."""
    q, t, ql, tl = planted_pairs(rng, n, lq, lt, lead=min(band, lt) // 2)
    ql[:4] = [0, lq, 1, max(lq - 1, 0)]
    tl[2:6] = [0, lt, 1, max(lt - 1, 0)]
    tl[n // 2:] = rng.integers(0, lt + 1, n - n // 2)
    q[6, :], t[6, :] = 4, 4
    t[7, : lt // 2] = -1
    q[7, ::3] = -1
    q[8:16, :], t[8:16, :] = 0, 0
    q[16:24, ::2], q[16:24, 1::2] = 0, 1
    t[16:24, ::2], t[16:24, 1::2] = 1, 0
    q[24:28, :], t[24:28, :] = -1, -1
    return q, t, ql, tl


def refine_cases(rng, A, N, Lq, band):
    """The refine's forward operands at one short-read width (planted,
    ragged qlen and tlen, a sentinel row, -1 codes, homopolymer and ACAC
    tie rows) and its reverse pass made from the forward results (reversed
    prefixes, twice the band).  Each case: (label, q, t, qlen, tlen,
    band)."""
    Lt = Lq + band + 8
    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt, lead=band // 2)
    ql[:4] = [0, 1, 31, Lq - 1]
    tl[4:8] = [0, 1, 30, Lt - 1]
    q[8, :] = 4                                   # sentinel rows
    t[8, :] = 4
    t[9, 10:40] = -1
    q[10:16, :] = 0                               # homopolymers
    t[10:16, :] = 0
    q[16:24, ::2], q[16:24, 1::2] = 0, 1          # ACAC... repeats
    t[16:24, ::2], t[16:24, 1::2] = 1, 0
    fwd = A.banded_sw_batch(*to_dev(q, t, ql, tl), band=band)
    rq, rt, rql, rtl = reversed_prefixes(q, t, fwd.qend.cpu().numpy(),
                                         fwd.tend.cpu().numpy())
    return [(f"forward (N {N}, Lq {Lq}, Lt {Lt}) band {band}",
             q, t, ql, tl, band),
            (f"reverse (N {N}, Lq {Lq}, Lt {Lt}) band {2 * band}, ragged "
             "qend/tend", rq, rt, rql, rtl, 2 * band)]


# phase 7's long queries: Lq 31,000 (a 4.6 Mb judged run's long pad) at the
# refine's bands, N cut to LONG_SW_PAIRS.  The plain version's ~62,000-step
# anti-diagonal loop takes ~15 s a call on the card, bound by its launches
# from one host thread, so it runs in a process of its own on the card,
# started after phase 1 beside phases 2 and 3 (plain_procs; on the CPU it
# took 200-300 s on the chip machine's host), and phase 7 holds the
# kernel's results against its output; phase 6 times the plain version at
# a cut, Lq LONG_SW_CUT
LONG_SW_LQ = 31_000
LONG_SW_PAIRS = 8
LONG_SW_BANDS = (64, 128)
LONG_SW_CUT = 3_100
SW_FIELDS = ("score", "qend", "tend")


def long_sw_case(band: int, lq: Optional[int] = None):
    """Phase 7's long-query operands at `band` (Lq LONG_SW_LQ unless `lq`),
    from a generator of their own (the plain version's process draws the
    same)."""
    import numpy as np

    lq = lq or LONG_SW_LQ
    return long_sw_pairs(np.random.default_rng(lq + band), LONG_SW_PAIRS,
                         lq, lq + band + 8, band)


# the long cases whose plain version runs in a process of its own: phase
# 2's gate at the long reads' pad (W 1,000; ~27 s) and phase 7's SW cases
LONG_PLAINS = ("gate", *(f"sw{b}" for b in LONG_SW_BANDS))
GATE_LONG = (64, 31_000)          # N, Lq of phase 2's longest gate case


def long_gate_case():
    """Phase 2's long-read gate case (N 64, Lq 31,000, Lt Lq + 72) from a
    generator of its own (the plain version's process draws the same)."""
    import numpy as np

    n, lq = GATE_LONG
    return myers_edges(np.random.default_rng(lq), n, lq, lq + 72)


def long_plain(name: str, out: str) -> None:
    """The plain version of one LONG_PLAINS case on the card: its outputs
    (dist, tend; or score, qend, tend) and seconds into out (.npz)."""
    import numpy as np
    import torch

    from hga_tpu_torch.ops import align as A
    from hga_tpu_torch.ops import myers as M

    case = long_gate_case() if name == "gate" else long_sw_case(
        int(name[2:]))
    args = to_dev(*case)
    t0 = time.perf_counter()
    if name == "gate":
        r = M.myers_batch(*args)
    else:
        r = A.banded_sw_batch(*args, band=int(name[2:]))
    torch.cuda.synchronize()
    np.savez(out, seconds=time.perf_counter() - t0,
             **{f: x.cpu().numpy() for f, x in r._asdict().items()})


@contextlib.contextmanager
def plain_procs(names):
    """Start long_plain for each of `names` in a process of its own on the
    card (one torch thread); yields {name: (process, .npz path)} and stops
    whatever is still running on the way out."""
    import subprocess

    d = tempfile.mkdtemp(prefix="hga_plain_")
    jobs = {}
    try:
        for name in names:
            out = os.path.join(d, f"{name}.npz")
            jobs[name] = (subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as S; "
                 f"S.long_plain({name!r}, {out!r})"], cwd=HERE,
                env=dict(os.environ, OMP_NUM_THREADS="1")), out)
        yield jobs
    finally:
        for p, _ in jobs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(d, ignore_errors=True)


def plain_ref(jobs, name: str, kind):
    """One LONG_PLAINS case's plain result (it waits for its process), as a
    `kind` (MyersResult or SWResult) of CPU tensors, and its seconds."""
    import numpy as np
    import torch

    p, out = jobs[name]
    t0 = time.perf_counter()
    if p.wait(timeout=900):
        fail(f"the plain version of {name} failed in its process")
    log(f"  waited {time.perf_counter() - t0:.1f} s for the plain version "
        f"of {name} in its process")
    z = np.load(out)
    return kind(*(torch.from_numpy(z[f]) for f in kind._fields)), \
        float(z["seconds"])


def long_sw_pairs(rng, n, lq, lt, band):
    """Planted pairs at a long query for few pairs: qlen 0, 1, Lq, ragged
    qlen and tlen, -1 and 4 codes."""
    q, t, ql, tl = planted_pairs(rng, n, lq, lt, lead=band // 2)
    ql[:3] = [0, 1, lq]
    ql[3] = lq // 3
    tl[4:6] = [lt // 2, 1]
    q[6, ::97], t[6, ::89] = -1, 4
    return q, t, ql, tl


def sw_cases(rng, A):
    """K3', K3'', K3''' (and K3 forced) checks: the refine's forward and
    reverse shapes at 100 bp reads (Lq 112: K3', and K3'' forced on the
    same inputs) and at 300 bp reads (Lq 320: K3'', and K3''' forced), band
    >= Lq, Lq 1024 and 1100, band 960 (K3''' on 4 warps a pair, and K3
    forced with its device scratch), K3' at every slot count's edges (Lq 1
    .. 256, and 257) at bands 0, 64, 128 and >= Lq, then K3'' at Lq 257,
    320 and 1024 at the CPU emulator's bands and at K's edges (band + 1 =
    32, 33, 64, 65, 256), then K3''' at Lq 31,000 (bands 64 and 128, N 8,
    long_sw_case) and past its register slots (band 2500: its slots in
    shared memory, and forced into the device scratch).  Each case: (label,
    q, t, qlen, tlen, band, and the forced runs: (kind, kernel_operands'
    options))."""
    band = ("band", {})
    cases = [(*c, (band,)) for c in refine_cases(rng, A, 4096, 112, 64)]
    cases += [(*c, (("wide", {}),))
              for c in refine_cases(rng, A, 4096, 320, 64)]
    sized = [(512, 40, 60, 200, "band >= Lq"),
             (256, 1024, 1100, 64, "Lq 1024"),
             (256, 1100, 1200, 64, "Lq 1100"),
             (64, 1000, 1000, 960, "band 960")]
    sized += [(512, lq, lq + 72, b, f"Lq {lq}")
              for lq in (1, 31, 32, 33, 112, 128, 129, 256, 257)
              for b in (0, 64, 128, lq + 7)]
    sized += [(512, lq, lq + 72, b, f"Lq {lq}")
              for lq, bands in ((257, (1, 127)),
                                (320, (0, 1, 31, 32, 63, 127, 128, 255,
                                       327)),
                                (1024, (0, 1, 127, 128, 1031)))
              for b in bands]
    for n, lq, lt, b, label in sized:
        forced = (("rows", {}),) if b == 960 or (b == lq + 7 and
                                                  lq in (257, 320)) else ()
        cases.append((f"{label} (N {n}, Lq {lq}, Lt {lt}) band {b}",
                      *sw_edges(rng, n, lq, lt, b), b, forced))
    lq = LONG_SW_LQ
    for b in LONG_SW_BANDS:
        cases.append((f"Lq {lq} (N {LONG_SW_PAIRS}, Lt {lq + b + 8}) band "
                      f"{b}", *long_sw_case(b), b, ()))
    cases.append(("past the register slots (N 64, Lq 2600, Lt 2672) band "
                  "2500", *sw_edges(rng, 64, 2600, 2672, 2500), 2500,
                  (("wide", {"scratch": True}),)))
    return cases


SW_KERNEL_NAME = {"diag": "K3'", "band": "K3''", "wide": "K3'''",
                  "rows": "K3 (rows)"}


def phase_k3(rng, AC, A, plains):
    """Every case through the wrapper, which picks the route by shape: the
    route's counter must move and K3's row counter stay 0 (no shape takes
    it); K3', K3'', K3''' and the forced K3 are reported apart, and each
    must have run.  The Lq 31,000 cases are held against the plain
    version's processes (`plains`, plain_procs)."""
    import torch

    log("phase 7: K3', K3'', K3''' (and K3 forced) banded_sw_batch_cuda vs "
        "plain, bit-exact")
    errs = {key: [] for key in AC.ROUTE_COUNTER.values()}
    rows = AC.ROUTE_COUNTER["rows"]
    for label, q, t, ql, tl, band, forced in sw_cases(rng, A):
        args = to_dev(q, t, ql, tl)
        Lq, Lt = q.shape[1], t.shape[1]
        r = AC.route(Lq, Lt, band)
        key = AC.ROUTE_COUNTER[r.kind]
        before = launch_counts()
        got = AC.banded_sw_batch_cuda(*args, band=band)
        if moved(before, launch_counts()) != {key: 1} or launch_counts()[rows]:
            fail(f"K3 {label}: counters moved {moved(before, launch_counts())}"
                 f" on the {r.kind} route (the row counter must stay 0)")
        if Lq == LONG_SW_LQ:
            ref, sec = plain_ref(plains, f"sw{band}", A.SWResult)
            label += f" (plain in its process, {sec:.1f} s)"
        else:
            ref = A.banded_sw_batch(*args, band=band)
        runs = [(f"{SW_KERNEL_NAME[r.kind]} (K {r.K}, {r.nw} warps a "
                 f"pair)", r.kind, tuple(got))]
        for kind, kw in forced:
            fr, *ops, outs = AC.kernel_operands(*args, band=band, kind=kind,
                                                **kw)
            AC.run_kernel(fr, *ops, outs)
            runs.append((f"{SW_KERNEL_NAME[kind]} forced {kw or ''}", kind,
                         outs))
        for name, kind, res in runs:
            for f, x in zip(("score", "qend", "tend"), res):
                errs[AC.ROUTE_COUNTER[kind]].append(
                    eq(f"{name} {label} {f}", x, getattr(ref, f)))
        if int(ref.score.max()) <= 0:
            fail(f"K3 {label}: no positive score")
    for key, e in errs.items():
        if not e:
            fail(f"phase 7 ran no case on {key}")
    return {k: max(v) for k, v in errs.items()}


_SIMULATED: dict = {}
# phase 8's second drive: 300 bp short reads (Illumina MiSeq 2 x 300), whose
# refine width (pad 320) takes K3'' (the band route), on a 100 kb genome
MISEQ_GENOME = 100_000
# phase 8's third drive: those reads at `--band 128`, whose reverse pass
# (band 256) takes K3''' (the wide route); its card == CPU check on a P8_CUT
# genome with short reads at E_CPU_COV (its CPU side, ~180 s at 30x on 3
# threads, then held phase 5 up by ~80 s)
P8_BAND = 128
P8_CUT = 20_000
# phase 4's genome, whose reads and run phases b, c and d reuse, near the
# smallest genomes of free-living bacteria (Mycoplasma genitalium, 580 kb);
# phase 8's first drive (config 3 with 100 bp reads) and phase 10's default
# genome.  Each cut from 1 Mb so that the smoke ends well inside its 1,200 s
# on a slow host (PERF.md section 4)
P4_GENOME = 500_000
CONFIG3_GENOME = 200_000
PHASE10_GENOME = 400_000
# phase 6's rows of segment_identity and of the ring's step: a 1 Mb genome
SEGMENT_GENOME = 1_000_000
# phase d's repeat genome (diag_repeat_corr, diag_leak, diag_polish_votes)
# and count_scale's genome there (card against CPU), cut from 1 Mb so that
# the phase stays near two minutes
DIAG_GENOME = 100_000
COUNT_GENOME = 200_000


def simulate(genome_len: int, seed: int, read_len: int = 100,
             repeats: bool = False, circular: bool = False):
    """The judged read model, hga_tpu_torch.exp.scale_run.simulate: (genome,
    short reads, long reads), made once per argument set and shared by the
    phases; `read_len` 300 (Illumina MiSeq's 2 x 300 reads) pads to 320."""
    key = (genome_len, seed, read_len, repeats, circular)
    if key not in _SIMULATED:
        from hga_tpu_torch.exp import scale_run as SR

        _SIMULATED[key] = SR.simulate(*key)
    return _SIMULATED[key]


def config3_cfg():
    """Judged config 3 (BASELINE.json configs[2]): the judged config with
    the scored SW refine; min_overlap_len 32 because the judged 500 is for
    corrected long reads and no 100 bp read can reach it."""
    from hga_tpu_torch.exp.scale_run import judged_cfg

    return judged_cfg().replace(overlap_refine="sw", min_overlap_len=32)


def short_only_cfg():
    """The short-read-only pipeline: config 3's overlap settings, short
    contigs allowed, copy arbitration on (the reference arbitrates only
    with long reads)."""
    return config3_cfg().replace(min_contig_len=300)


@contextlib.contextmanager
def stage_launches(into: dict, where=None, name="arbitrate_contigs"):
    """Count the kernel launches made inside one of the pipeline's stages,
    by default the arbitrate stage: models/pipeline calls the stage's
    function `name` through the module `where` (models/arbitration, or
    models/pipeline's own names for correct_long_reads and polish_contigs),
    so a wrapper there sees the stage's launches (`into` gets the counter
    deltas).  It changes nothing the stage computes."""
    if where is None:
        from hga_tpu_torch.models import arbitration as where

    inner = getattr(where, name)

    def counted(*a, **kw):
        before = launch_counts()
        try:
            return inner(*a, **kw)
        finally:
            for k, v in (launch_counts() - before).items():
                into[k] = into.get(k, 0) + v

    setattr(where, name, counted)
    try:
        yield into
    finally:
        setattr(where, name, inner)


def run_judged(label: str, genome_len: int, MC, workdir: str,
               repeats: bool = False, circular: bool = False):
    """The judged pipeline on the card through hga_tpu_torch.exp.scale_run
    (run, then scale_metrics, as its main() does; run resumes as the JAX
    script does, here from a fresh directory); the main path's launches
    (K1' and K2' must move, K2' also inside the arbitrate stage, K2 stays
    0), stage seconds and splits, split_reconciliation (a WARNING fails),
    and the quality by utils/evalx (judged as a circle when `circular`)."""
    import torch

    from hga_tpu_torch.exp import scale_run as SR

    t0 = time.perf_counter()
    genome, pr_s, pr_l = simulate(genome_len, 42, repeats=repeats,
                                  circular=circular)
    log(f"  simulated {pr_s.n_reads} short + {pr_l.n_reads} long reads "
        f"in {time.perf_counter() - t0:.1f} s (long pad {pr_l.pad_len}, "
        f"repeats {repeats}, circular {circular})")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    arb = {}
    with stage_launches(arb):
        res, wall = SR.run(pr_s, pr_l, SR.judged_cfg(),
                           os.path.join(workdir, label), device="cuda")
    launches = launch_counts()
    log(f"  launches on the main path: {json.dumps(launches)}; in the "
        f"arbitrate stage: {json.dumps(arb)}")
    for name in ("myers_batch_cuda", "myers_votes_cuda"):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    if k2v_launches(arb) <= 0:
        fail("K2' was never launched in the arbitrate stage")
    if launches["myers_batch_planes_cuda"] or \
            launches["myers_batch_planes_cuda_wide"]:
        fail("K2s (myers_batch_planes_cuda) ran on the main path, where K2' "
             "replaces it")
    metrics, warnings = SR.scale_metrics(res, genome, pr_s, pr_l, wall,
                                         genome_len / 1e6, repeats, circular)
    stages = {k: v["seconds"] for k, v in res.stats["stages"].items()}
    ev = metrics["eval"]
    out = dict(genome_len=genome_len, repeats=repeats, circular=circular,
               n_short=pr_s.n_reads, n_long=pr_l.n_reads,
               pipeline_s=round(wall, 3), stage_s=stages,
               seed_index_s=res.stats.get("seed_index_s"),
               correction_detail=res.stats.get("correction_detail"),
               polish_detail=res.stats.get("polish_detail"),
               arbitrate_detail=res.stats.get("arbitrate_detail"),
               overlaps=res.stats.get("overlaps"),
               assembly=res.stats.get("assembly"), eval=ev,
               split_reconciliation=metrics["split_reconciliation"],
               peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
               launches=launches, arbitrate_launches=arb)
    log("  pipeline: " + json.dumps(out))
    if warnings:
        fail("split_reconciliation: " + "; ".join(warnings))
    if not res.polished:
        fail("the pipeline produced no contig")
    if "arbitrate" not in stages:
        fail("the arbitrate stage did not run")
    if ev["identity"] < 0.99:
        fail(f"k-mer identity {ev['identity']:.5f} < 0.99")
    return launches, out, genome, res.polished


def phase_pipeline(genome_len: int, MC, workdir: str):
    """Phase 4; returns its launches and {out, polished, dir} (phase c holds
    its two ranks against this one-rank run)."""
    log(f"phase 4: run_pipeline(device='cuda') on a {genome_len} bp genome")
    launches, out, _, polished = run_judged("p4", genome_len, MC, workdir)
    return launches, dict(out=out, polished=polished,
                          dir=os.path.join(workdir, "p4"))


PHASE10_GENOMES = {"repeats": (True, False), "circular": (False, True),
                   "repeats+circular": (True, True)}


def phase_genomes(genome_len: int, kinds, MC, workdir: str):
    """Phase 10: the judged pipeline on the repeat-bearing and circular
    genomes of exp/scale_run.py, then segment_identity of the polished
    contigs on the card (K1''s shared-target mode).  Returns {path: launch
    counts}."""
    import torch

    from hga_tpu_torch.utils.evalx import segment_identity

    paths = {}
    for kind in kinds:
        repeats, circular = PHASE10_GENOMES[kind]
        log(f"phase 10: run_pipeline(device='cuda') on a {genome_len} bp "
            f"genome, {kind}")
        t0 = time.perf_counter()
        paths[f"phase 10 {kind} pipeline"], out, genome, polished = \
            run_judged(f"p10_{kind}", genome_len, MC, workdir,
                       repeats=repeats, circular=circular)
        zero_launches()
        t1 = time.perf_counter()
        seg = segment_identity(polished, genome, device="cuda")
        torch.cuda.synchronize()
        seg["seconds"] = round(time.perf_counter() - t1, 3)
        launches = launch_counts()
        paths[f"phase 10 {kind} segment_identity"] = launches
        ev = out["eval"]
        log(f"  phase 10 {kind}: " + json.dumps(dict(
            n_contigs=ev["n_contigs"],
            circular_contigs=ev["circular_contigs"],
            identity=ev["identity"], judged_as_circle=circular,
            genome_fraction=ev["genome_fraction"], total_len=ev["total_len"],
            genome_len=genome_len, **seg, launches=launches)))
        if launches["myers_batch_cuda_shared"] <= 0:
            fail("segment_identity did not launch K1''s shared-target mode")
        log(f"  phase 10 {kind}: {time.perf_counter() - t0:.1f} s")
    return paths


def same_outputs(dirs, text, npz) -> None:
    """Fail unless the two output directories of `dirs` ({label: dir}, e.g.
    cuda and cpu) hold byte-identical text files and equal arrays."""
    import numpy as np

    (la, da), (lb, db) = dirs.items()
    for f in text:
        a = open(os.path.join(da, f), "rb").read()
        b = open(os.path.join(db, f), "rb").read()
        if a != b:
            fail(f"{f} differs between {la} and {lb}")
        log(f"  ok: {f} byte-identical ({len(a)} bytes)")
    for f in npz:
        za = np.load(os.path.join(da, f))
        zb = np.load(os.path.join(db, f))
        if sorted(za.files) != sorted(zb.files):
            fail(f"{f}: keys differ")
        for k in za.files:
            if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k]):
                fail(f"{f}[{k}] differs between {la} and {lb}")
        log(f"  ok: {f} arrays equal ({len(za.files)} arrays)")


# ------------------------------------------------ card == CPU twin runs

# the runs held byte for byte between the card and the CPU (phases 5, b and
# e): each runs on the card in this process and on the CPU in a process of
# its own, all of them started once the timed pipelines of phases 4, 8, 10,
# c and b are done, beside phase d and phase 5's card side; phase e's timed
# pipelines wait for them to end; name -> (the text files, the arrays)
# compared
_PIPE = ("contigs.fasta", "assembly.gfa", "polished.fasta")
_HYBRID = (_PIPE + ("arbitrated.fasta",),
           ("spectrum.npz", "corrected.npz", "overlaps.npz"))
_SHORT = (_PIPE, ("spectrum.npz", "candidates.npz", "overlaps.npz"))
_CROSS = (("overlaps.paf",), ("overlaps.npz",))
TWINS = {"p5_hybrid": _HYBRID, "p5_config3": _CROSS,
         "p5_config3_300": _CROSS, "p5_short": _SHORT, "p8_band128": _CROSS,
         "b_sw_correct": ((), ("corrected.npz",)), "b_sw_hybrid": _HYBRID,
         "e_hybrid": _HYBRID, "e_cross": _CROSS, "e_short": _SHORT,
         "e_short1024": _SHORT, "e_overlap_long": _CROSS,
         "e_correct1120": ((), ("corrected.npz",))}


def _twin_spec(name: str):
    """(kind, reads (genome, short, long), config) of one twin run: phase
    5's hybrid pipeline (20 kb), config 3 with 100 and 300 bp reads and
    the short-read-only pipeline (8 kb); phase b's scored-SW correction
    engine (correct_long_reads at 8 kb, the 20 kb pipeline); phase e's
    four runs at E_CUT (pads 800 and 1024), correct_long_reads with short
    reads padded to 1120 (W 37) and `hga-torch overlap --long` on E_CUT's
    judged long reads (phase 4's seed)."""
    from hga_tpu_torch.exp.scale_run import judged_cfg

    sw = lambda: judged_cfg().replace(corr_engine="sw")
    wide = lambda read_len: lambda: e_reads(E_CUT, read_len, 61,
                                            short_cov=E_CPU_COV)
    e3 = lambda: e_cfgs()[0]
    es = lambda: e_cfgs()[1]
    return {
        "p5_hybrid": ("pipeline", lambda: simulate(20_000, seed=7),
                      judged_cfg),
        "p5_config3": ("cross", lambda: simulate(8_000, seed=8),
                       config3_cfg),
        "p5_config3_300": ("cross", lambda: simulate(8_000, seed=9,
                                                     read_len=300),
                           config3_cfg),
        "p5_short": ("short", lambda: simulate(8_000, seed=8),
                     short_only_cfg),
        "p8_band128": ("cross", lambda: e_reads(P8_CUT, 300, 44,
                                                short_cov=E_CPU_COV),
                       lambda: config3_cfg().replace(band=P8_BAND)),
        "b_sw_correct": ("correct", lambda: simulate(8_000, seed=8), sw),
        "b_sw_hybrid": ("pipeline", lambda: simulate(20_000, seed=7), sw),
        "e_hybrid": ("pipeline", wide(780), judged_cfg),
        "e_cross": ("cross", wide(780), e3),
        "e_short": ("short", wide(780), es),
        "e_short1024": ("short", wide(1000), es),
        "e_overlap_long": ("overlap_long", lambda: simulate(E_CUT, 42),
                           None),
        "e_correct1120": ("correct", wide(1100), judged_cfg),
    }[name]


def twin_run(name: str, outdir: str, device: str) -> int:
    """One of TWINS on `device`, its artifacts in outdir/name; returns its
    contigs (reads for a correction, records for config 3)."""
    from hga_tpu_torch.models import correction as CR
    from hga_tpu_torch.models.overlap import compute_overlaps_cross
    from hga_tpu_torch.models.pipeline import run_pipeline

    kind, reads, cfg = _twin_spec(name)
    _, pr_s, pr_l = reads()
    d = os.path.join(outdir, name)
    if kind == "overlap_long":
        return overlap_long(pr_l, d, device)
    if kind in ("pipeline", "short"):
        return len(run_pipeline(pr_s, pr_l if kind == "pipeline" else None,
                                cfg(), d, device=device).polished)
    os.makedirs(d)
    if kind == "correct":
        out = CR.correct_long_reads(pr_s, pr_l, cfg(), device=device)
        out.save(os.path.join(d, "corrected.npz"))
        return out.n_reads
    ov = compute_overlaps_cross(pr_s, pr_l, cfg(), device=device)
    ov.save(os.path.join(d, "overlaps.npz"))
    with open(os.path.join(d, "overlaps.paf"), "w") as fh:
        fh.write(ov.to_paf(pr_s.names, pr_l.names))
    return ov.n


def overlap_long(pr_l, d: str, device: str) -> int:
    """`hga-torch overlap --long` through cli.main with the judged seeding
    (-k 15 -w 5) on the first E_LONG_READS reads of `pr_l`, written as
    FASTA; returns the overlaps it found."""
    import numpy as np

    from hga_tpu_torch import cli
    from hga_tpu_torch.io.encode import unpack_codes

    os.makedirs(d)
    fa = os.path.join(d, "long.fa")
    codes = unpack_codes(pr_l.packed[:E_LONG_READS])
    with open(fa, "w") as fh:
        for name, row, n in zip(pr_l.names, codes, pr_l.length):
            fh.write(f">{name}\n"
                     f"{np.frombuffer(b'ACGT', np.uint8)[row[:n]].tobytes().decode()}\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["overlap", "--long", fa, "-o", d, "-k", "15", "-w",
                       "5", "--device", device])
    if rc:
        fail(f"hga-torch overlap --long on {device} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])["overlaps"]


P5_TWINS = ("p5_hybrid", "p5_config3", "p5_config3_300", "p5_short")
P8_TWINS = ("p8_band128",)
B_TWINS = ("b_sw_correct", "b_sw_hybrid")
E_TWINS = ("e_hybrid", "e_cross", "e_short", "e_short1024",
           "e_overlap_long", "e_correct1120")
# torch threads of a CPU twin run: one, or more for the four longest (the
# plain SW refine at Lq 320 and the sw engine, ~110 s on one thread; the
# plain K1' at the long reads' pad, W ~645; the plain K2' at W 37)
TWIN_THREADS = {"p5_config3_300": 3, "b_sw_hybrid": 2, "e_overlap_long": 2,
                "e_correct1120": 2, "p8_band128": 3}


@contextlib.contextmanager
def cpu_twins(names, workdir: str):
    """Start the CPU side of the twin runs `names`, each in a process of its
    own at the lowest priority (nice 19) on the last 3/8 of this process's
    CPUs (the phases on the card keep the rest: beside them on every CPU,
    at nice 19 still, the runs made phase 2 2.7x slower; on half, 1.9x), with
    OMP_NUM_THREADS from TWIN_THREADS, writing under workdir/cpu; each
    prints the time it ended last.  Yields the jobs and stops whatever is
    still running on the way out."""
    import subprocess

    cpus = sorted(os.sched_getaffinity(0))
    cpus = set(cpus[len(cpus) - max(1, 3 * len(cpus) // 8):])
    jobs = []
    try:
        for name in names:
            out = os.path.join(workdir, f"cpu_{name}.log")
            call = (f"S.twin_run({name!r}, "
                    f"{os.path.join(workdir, 'cpu')!r}, 'cpu')")
            with open(out, "w") as fh:
                jobs.append((name, out, subprocess.Popen(
                    [sys.executable, "-c", "import os, time; os.nice(19); "
                     f"os.sched_setaffinity(0, {cpus!r}); "
                     f"import chip_smoke as S; {call}; "
                     "print('ended', time.time())"],
                    cwd=HERE, stdout=fh, stderr=subprocess.STDOUT,
                    env=dict(os.environ, OMP_NUM_THREADS=str(
                        TWIN_THREADS.get(name, 1))))))
        yield jobs
    finally:
        for _, _, p in jobs:
            if p.poll() is None:
                p.kill()
            p.wait()


def card_twin(name: str, workdir: str, MC, AC):
    """The card side of one twin run; returns (its result count, the
    launches it made)."""
    import torch

    zero_launches()
    t0 = time.perf_counter()
    n = twin_run(name, os.path.join(workdir, "cuda"), "cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"  {name} on cuda: {n} in {time.perf_counter() - t0:.1f} s; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if n == 0:
        fail(f"{name} on cuda gave no result")
    return n, launches


def twins_wait(jobs) -> None:
    """Wait for the CPU side of `jobs`; fail if one failed."""
    t0 = time.perf_counter()
    ended = []
    for name, out, p in jobs:
        if p.wait(timeout=900):
            fail(f"the CPU run {name} failed: {open(out).read()[-3000:]}")
        at = re.findall(r"^ended (\S+)$", open(out).read(), re.M)
        ended.append(f"{name} {float(at[-1]) - _T0_WALL:.1f}" if at
                     else f"{name} ?")
    log(f"  waited {time.perf_counter() - t0:.1f} s for the CPU runs; each "
        f"ended at (s since the smoke started): {', '.join(ended)}")


def twins_equal(jobs, workdir: str) -> None:
    """Wait for the CPU side of `jobs`, then hold each run's artifacts
    against the card's, byte for byte."""
    twins_wait(jobs)
    for name, _, _ in jobs:
        log(f"  {name}: cuda vs cpu")
        same_outputs({d: os.path.join(workdir, d, name)
                      for d in ("cuda", "cpu")}, *TWINS[name])


def phase_cpu_equal(workdir: str, MC, AC):
    """Phase 5, the card side: the hybrid pipeline (20 kb, arbitrated.fasta
    included), config 3 with 100 and 300 bp reads and the short-read-only
    pipeline (8 kb) on cuda (main holds them against their CPU side); on
    cuda config 3's refine must go through the SW route its width takes,
    and no other."""
    log("phase 5: the same work on cuda and on cpu, byte-identical")
    cfg = config3_cfg()
    for name in P5_TWINS:
        _, launches = card_twin(name, workdir, MC, AC)
        if "config3" in name:
            pad = 320 if name.endswith("300") else 112
            want = {AC.ROUTE_COUNTER[k]
                    for k in config3_routes(AC, pad, cfg.band)}
            if {k for k in AC.ROUTE_COUNTER.values() if launches[k]} != want:
                fail(f"{name} (pad {pad}) launched {launches}, not {want}")


def p8_band128_card(workdir: str, MC, AC):
    """Phase 8's card == CPU check at --band 128, the card side: config 3
    with 300 bp reads on a P8_CUT genome; K3'' (forward) and K3''' (the
    reverse pass at band 256) must move, K3's rows stay 0.  main holds its
    records against the CPU side's, which runs with the other twins."""
    _, launches = card_twin("p8_band128", workdir, MC, AC)
    want = {AC.ROUTE_COUNTER[k] for k in config3_routes(AC, 320, P8_BAND)}
    if {k for k in AC.ROUTE_COUNTER.values() if launches[k]} != want:
        fail(f"p8_band128 launched {launches}, not {want}")


# ---------------------------------------------------------------- phase e

# phase e: short reads past 24 Myers words, 780 bases padded to 800 (W 26)
# and 1000 padded to 1024 (W 34: two words a lane), K1' and K2' at both;
# the hybrid pipeline at E_GENOME with the judged read model; the card ==
# CPU runs at E_CUT with short reads at E_CPU_COV (cut from 30x so that the
# four CPU runs, in processes of their own, stay near 30-45 s)
E_GENOME = 100_000
E_CUT = 20_000
E_CPU_COV = 12.0
# `hga-torch overlap --long` takes the first this many of E_CUT's judged
# long reads (~4x of its 20x): the plain K1' on the CPU side (W ~645,
# ~20,000 columns) then stays near a minute
E_LONG_READS = 10


def e_reads(genome_len: int, read_len: int, seed: int,
            short_cov: float = 30.0):
    """The judged read model (exp/scale_run.simulate_reads) with
    `read_len`-base short reads at `short_cov`: (genome, short PackedReads
    padded to read_len + 12 rounded up to 32, long PackedReads)."""
    from hga_tpu_torch.exp import scale_run as SR
    from hga_tpu_torch.utils import sim

    genome = sim.random_genome(genome_len, seed=seed)
    short = sim.simulate_short_reads(genome, coverage=short_cov,
                                     read_len=read_len, error_rate=0.01,
                                     seed=seed + 1)
    long_ = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                    min_len=1000, error_rate=0.10,
                                    seed=seed + 2)
    return (genome, *SR.pack(short, long_, read_len))


def e_cfgs():
    """Config 3 and the short-read-only pipeline with the judged config's
    Myers refine (K1' gates and refines; the SW refine's plain version
    takes ~10x longer at Lq 800 on the CPU side)."""
    return (config3_cfg().replace(overlap_refine="myers"),
            short_only_cfg().replace(overlap_refine="myers"))


def e_hybrid(MC, workdir: str):
    """Phase e, 1: the hybrid pipeline on an E_GENOME genome with 780-base
    short reads (pad 800, 30x, 1% error) and the judged long-read model:
    K2' must move in correction and in polish, on the route W 26 takes,
    K1' must move; identity >= 0.99."""
    import torch

    from hga_tpu_torch.exp import scale_run as SR
    from hga_tpu_torch.models import pipeline as PL

    genome, pr_s, pr_l = e_reads(E_GENOME, 780, 45)
    W = (pr_s.pad_len + 30) // 31
    key = MC.votes_counter(MC.votes_route(pr_s.pad_len,
                                          pr_s.pad_len + 64 + 8))
    log(f"  {pr_s.n_reads} short reads (pad {pr_s.pad_len}, W {W}) + "
        f"{pr_l.n_reads} long reads; K2''s route at W {W}: {key}")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    corr, pol = {}, {}
    t0 = time.perf_counter()
    with stage_launches(corr, PL, "correct_long_reads"), \
            stage_launches(pol, PL, "polish_contigs"):
        res, wall = SR.run(pr_s, pr_l, SR.judged_cfg(),
                           os.path.join(workdir, "e100_hybrid"),
                           device="cuda")
    launches = launch_counts()
    metrics, _ = SR.scale_metrics(res, genome, pr_s, pr_l, wall,
                                  E_GENOME / 1e6, False, False)
    ev = metrics["eval"]
    out = dict(pipeline_s=round(wall, 3), stage_s={
        k: v["seconds"] for k, v in res.stats["stages"].items()},
        launches=launches, correction=corr, polish=pol,
        contigs=ev.get("n_contigs"), identity=ev["identity"],
        genome_fraction=ev.get("genome_fraction"),
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    log("  e hybrid: " + json.dumps(out))
    for stage, got in (("correction", corr), ("polish", pol)):
        if got.get(key, 0) <= 0:
            fail(f"K2' ({key}) did not move in {stage} at W {W}")
    if launches["myers_batch_cuda"] <= 0:
        fail("K1' did not move on the hybrid pipeline")
    if ev["identity"] < 0.99:
        fail(f"k-mer identity {ev['identity']:.5f} < 0.99")
    log(f"  e hybrid: {time.perf_counter() - t0:.1f} s")
    return launches, pr_s, pr_l


def e_short(MC, pr_s, pr_l, workdir: str):
    """Phase e, 2: config 3's overlaps and the short-read-only pipeline on
    phase e's 100 kb short reads (pad 800): K1' must move at W 26."""
    from hga_tpu_torch.models.overlap import compute_overlaps_cross
    from hga_tpu_torch.models.pipeline import run_pipeline

    cross_cfg, short_cfg = e_cfgs()
    zero_launches()
    t0 = time.perf_counter()
    ov = compute_overlaps_cross(pr_s, pr_l, cross_cfg, device="cuda")
    t1 = time.perf_counter()
    res = run_pipeline(pr_s, None, short_cfg,
                       os.path.join(workdir, "e100_short"), device="cuda")
    launches = launch_counts()
    log(f"  e config 3: {ov.n} records in {t1 - t0:.1f} s; short-read-only "
        f"pipeline: {res.stats['overlaps']['n']} overlaps, "
        f"{len(res.polished)} contigs in {time.perf_counter() - t1:.1f} s; "
        f"launches {json.dumps(launches)}")
    if ov.n == 0 or not res.polished:
        fail("phase e's short reads gave no record or no contig")
    if launches["myers_batch_cuda"] <= 0:
        fail("K1' did not move on config 3 at W 26")
    return launches


def e_bench(MC, AC):
    """Phase e, 5: hga_tpu_torch.bench.main() in this process: one JSON
    line with bench.py's keys in its order; K1' and K3' must move."""
    from hga_tpu_torch import bench

    before = launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    log(f"  e bench: {lines[0]} | {lines[-1]}")
    keys = ["metric", "value", "unit", "vs_baseline", "scored_sw_gcups",
            "scored_sw_impl"]
    if rc or list(line) != keys or line["metric"] != \
            "overlap_dp_gcups_per_chip" or line["scored_sw_impl"] != "cuda_k3":
        fail(f"hga_tpu_torch.bench printed {lines[-1]}")
    got = moved(before, launch_counts())
    if got.get("myers_batch_cuda", 0) <= 0 or \
            got.get("banded_sw_batch_cuda", 0) <= 0:
        fail(f"hga_tpu_torch.bench moved {got}, not K1' and K3'")
    return got


def e_graft(AC, A):
    """Phase e, 6: graft_entry.entry() on the card == K3''s plain version on
    the same inputs, bit-exact (K3' must move), then dryrun_multichip(1), a
    world of one on NCCL."""
    from hga_tpu_torch import graft_entry as GE

    fn, args = GE.entry()
    before = launch_counts()
    got = fn(*args)
    step = moved(before, launch_counts())
    if step != {"banded_sw_batch_cuda": 1}:
        fail(f"graft_entry.entry()'s step moved {step}, not K3' once")
    ref = A.banded_sw_batch(*args, **fn.keywords)
    err = max(eq(f"graft_entry.entry() {f}", getattr(got, f),
                 getattr(ref, f)) for f in ("score", "qend", "tend"))
    t0 = time.perf_counter()
    (rank0,) = GE.dryrun_multichip(1)
    log(f"  e dryrun_multichip(1): backend {rank0['backend']}, "
        f"{len(rank0['polished'])} polished contigs, launches "
        f"{json.dumps(rank0['launches'])}, {time.perf_counter() - t0:.1f} s")
    if rank0["backend"] != "nccl" or rank0["world"] != 1:
        fail(f"dryrun_multichip(1) ran on {rank0['backend']}, not NCCL")
    for k in ("banded_sw_batch_cuda", "myers_batch_cuda_carry",
              "myers_batch_cuda"):
        if rank0["launches"].get(k, 0) <= 0:
            fail(f"dryrun_multichip(1) did not launch {k}")
    return step, rank0["launches"], err


def phase_wide(workdir: str, MC, AC, A, jobs):
    """Phase e (see the module docstring; `jobs`: the CPU side of its twin
    runs, ended before it starts); returns its paths' launches and K3''s
    error on graft_entry's step."""
    log("phase e: short reads past 24 words (pads 800 and 1024), "
        "`hga-torch overlap --long` (the wide route), hga_tpu_torch.bench "
        "and graft_entry")
    te = time.perf_counter()
    paths = {}
    paths["phase e hybrid, pad 800"], pr_s, pr_l = e_hybrid(MC, workdir)
    paths["phase e config 3 and short-only, pad 800"] = e_short(
        MC, pr_s, pr_l, workdir)
    for name in E_TWINS:
        _, launches = card_twin(name, workdir, MC, AC)
        if name == "e_short1024" and not (
                launches["myers_batch_cuda"] > 0
                and launches["myers_votes_cuda_scratch"] > 0):
            fail(f"{name}: K1' and K2' (scratch) did not both move at W 34: "
                 f"{launches}")
        if name == "e_overlap_long" and \
                launches["myers_batch_cuda_wide"] <= 0:
            fail(f"{name}: K1''s wide route did not move: {launches}")
        if name == "e_correct1120" and \
                launches["myers_votes_cuda_wide"] <= 0:
            fail(f"{name}: K2''s wide route did not move: {launches}")
        paths[f"phase e {name}, {E_CUT} bp"] = launches
    zero_launches()
    paths["phase e hga_tpu_torch.bench"] = e_bench(MC, AC)
    g_moved, rank_launches, err = e_graft(AC, A)
    paths["phase e graft_entry.entry()"] = g_moved
    paths["phase e dryrun_multichip(1), rank 0"] = rank_launches
    twins_equal(jobs, workdir)
    log(f"  phase e: {time.perf_counter() - te:.1f} s")
    return paths, err


def write_reads(path: str, pr) -> int:
    """Write a PackedReads set as FASTQ (quality 'I'), its bases decoded
    from the packed codes; returns the file's bytes."""
    import numpy as np

    from hga_tpu_torch.io.encode import unpack_codes
    from hga_tpu_torch.io.fastq import write_fastq

    bases = np.frombuffer(b"ACGT", np.uint8)[unpack_codes(pr.packed)]
    lens = pr.length.tolist()
    write_fastq(path, ((pr.names[i], bases[i, :n].tobytes().decode(),
                        "I" * n) for i, n in enumerate(lens)))
    return os.path.getsize(path)


def same_reads(label: str, a, b) -> None:
    """Fail unless two PackedReads hold equal arrays, names and pad."""
    import numpy as np

    for f in ("packed", "bad", "length", "category"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            fail(f"{label}: {f} differs")
    if a.names != b.names or a.pad_len != b.pad_len:
        fail(f"{label}: names or pad_len differ")


def phase_native(genome_len: int, workdir: str):
    """Phase b, the native reader: phase 4's reads (simulated with its
    seed) written as FASTQ, the long reads once more as .fastq.gz, loaded
    by load_reads on the native route and by its Python reader; the routes
    array-equal (and equal to the simulated reads); seconds and reads/s."""
    import gzip

    from hga_tpu_torch.io import native as NV
    from hga_tpu_torch.models import pipeline as PL

    log("phase b: the native FASTQ reader against the Python reader, "
        f"phase 4's reads ({genome_len} bp genome)")
    _, pr_s, pr_l = simulate(genome_len, 42)
    t0 = time.perf_counter()
    if not NV.available():
        fail(f"the native reader did not build: {NV.UNAVAILABLE}")
    build_s = time.perf_counter() - t0
    files = {k: os.path.join(workdir, f"pb_{k}") for k in
             ("short.fastq", "long.fastq", "long.fastq.gz")}
    t0 = time.perf_counter()
    nbytes = write_reads(files["short.fastq"], pr_s) \
        + write_reads(files["long.fastq"], pr_l)
    with open(files["long.fastq"], "rb") as src, \
            gzip.open(files["long.fastq.gz"], "wb", compresslevel=6) as dst:
        shutil.copyfileobj(src, dst)
    write_s = time.perf_counter() - t0
    pads = (pr_s.pad_len, pr_l.pad_len)
    n = pr_s.n_reads + pr_l.n_reads
    out = dict(short_reads=pr_s.n_reads, long_reads=pr_l.n_reads,
               fastq_mb=round(nbytes / 1e6, 3),
               gz_mb=round(os.path.getsize(files["long.fastq.gz"]) / 1e6, 3),
               build_s=round(build_s, 3), write_s=round(write_s, 3))
    t0 = time.perf_counter()
    nat = PL.load_reads([files["short.fastq"]], [files["long.fastq"]], *pads)
    out["native_s"] = time.perf_counter() - t0
    if PL.LAST_LOAD.get("route") != "native":
        fail(f"load_reads took {PL.LAST_LOAD}, not the native route")
    t0 = time.perf_counter()
    py = PL._load_python([files["short.fastq"]], [files["long.fastq"]],
                         *pads, False)
    out["python_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, gz = PL.load_reads([], [files["long.fastq.gz"]], *pads)
    out["native_gz_long_s"] = time.perf_counter() - t0
    for label, a, b in (("short, native vs python", nat[0], py[0]),
                        ("long, native vs python", nat[1], py[1]),
                        ("long, gzip vs plain", gz, nat[1]),
                        ("short, native vs simulated", nat[0], pr_s),
                        ("long, native vs simulated", nat[1], pr_l)):
        same_reads(label, a, b)
    out.update(native_reads_per_s=n / out["native_s"],
               python_reads_per_s=n / out["python_s"],
               native_gz_long_reads_per_s=pr_l.n_reads
               / out["native_gz_long_s"])
    log("  ingest: " + json.dumps(out))
    return out


def phase_sw_engine(workdir: str, MC, AC):
    """Phase b, the card side of the scored-SW correction engine
    (corr_engine="sw", plain torch): correct_long_reads on an 8 kb genome,
    then phase 5's 20 kb hybrid pipeline; K1' (long overlaps) must move on
    the card and K2' must not.  Returns the pipeline's launches on the
    card."""
    k2v = ("myers_votes_cuda", "myers_votes_cuda_scratch",
           "myers_batch_planes_cuda")
    log("phase b: corr_engine='sw', correct_long_reads on an 8 kb genome "
        "and the hybrid pipeline on a 20 kb one, cuda and cpu")
    for name in ("b_sw_correct", "b_sw_hybrid"):
        _, launches = card_twin(name, workdir, MC, AC)
        if any(launches[k] for k in k2v):
            fail(f"the sw engine launched a Myers planes kernel in {name}: "
                 f"{json.dumps(launches)}")
    if launches["myers_batch_cuda"] <= 0:
        fail("K1' (myers_batch_cuda) was never launched by the sw-engine "
             "pipeline's long overlaps")
    return launches


def bench_correction_path(cli, MC):
    """`hga-torch bench --what correction --pairs 4096` through cli.main:
    both engines (K2' for myers, whose counter must move)."""
    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--what", "correction", "--pairs", "4096"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = launch_counts()
    log(f"  bench correction ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(res)}")
    if rc != 0 or set(res) != {"myers", "sw"}:
        fail(f"bench --what correction: rc {rc}, engines {sorted(res)}")
    if res["myers"]["impl"] != "cuda_k2v" or launches["myers_votes_cuda"] <= 0:
        fail("bench --what correction did not run K2' for the myers engine")
    gap = res["sw"]["seconds"] / res["myers"]["seconds"]
    log(f"  the sw engine takes {gap:.1f}x K2''s time a batch")
    return res, launches


def trace_summary(path: str):
    """Kernel events of a torch.profiler Chrome trace: their names, the
    union of their intervals over the traced window (the device busy
    share), and the window."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in events
                  if e.get("cat") == "kernel")
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, lo
    for a, b, _ in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(window_ms=(hi - lo) / 1e3, kernel_events=len(kern),
                k2v_events=sum(1 for *_, n in kern
                               if "myers_votes_kernel" in n),
                busy_ms=busy / 1e3, busy_share=busy / (hi - lo) if hi > lo
                else 0.0, top_kernels_ms={n[:80]: v / 1e3 for n, v in top},
                categories=sorted({str(e.get("cat")) for e in events}))


def phase_profile(cli, workdir: str, MC):
    """Phase b: `hga-torch correct --profile DIR` on an 8 kb genome's
    reads (FASTQ): the trace must hold K2''s kernel events
    (myers_votes_kernel, launched from its ctypes library); the device
    busy share of the traced window.  Then `count` and its spectrum.png."""
    _, pr_s, pr_l = simulate(8_000, seed=8)
    s = os.path.join(workdir, "pb_prof_short.fastq")
    lr = os.path.join(workdir, "pb_prof_long.fastq")
    write_reads(s, pr_s)
    write_reads(lr, pr_l)
    prof = os.path.join(workdir, "pb_prof")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["correct", "--short", s, "--long", lr, "-k", "15",
                       "-w", "5", "--band", "64", "-o",
                       os.path.join(workdir, "pb_corr"), "--profile", prof])
    launches = launch_counts()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"hga-torch correct --profile: rc {rc}")
    summ = trace_summary(os.path.join(prof, "trace.json"))
    log(f"  correct --profile ({wall:.1f} s, K2' launches "
        f"{launches['myers_votes_cuda']}): " + json.dumps(summ))
    if not summ["k2v_events"]:
        fail("the profiler trace holds no kernel event of K2' "
             "(myers_votes_kernel)")
    log(f"  device busy share of the traced window: "
        f"{summ['busy_share']:.4f}")
    cnt = os.path.join(workdir, "pb_count")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["count", "--short", s, "-k", "15", "-o", cnt])
    try:
        import matplotlib  # noqa: F401
        mpl = True
    except ImportError:
        mpl = False
    png = os.path.exists(os.path.join(cnt, "spectrum.png"))
    log(f"  count: rc {rc}, matplotlib importable {mpl}, spectrum.png "
        f"written {png}")
    if rc != 0 or png != mpl:
        fail("count did not write spectrum.png as matplotlib allows")
    return summ, launches


def phase_b(genome_len: int, workdir: str, MC, AC):
    """Phase b: the native reader, the card side of the sw correction
    engine's twin runs (their CPU side runs later, see main), bench --what
    correction, --profile and spectrum.png.  Returns {path: launches}."""
    from hga_tpu_torch import cli

    tb = time.perf_counter()
    phase_native(genome_len, workdir)
    log(f"  native reader: {time.perf_counter() - tb:.1f} s")
    t0 = time.perf_counter()
    paths = {"phase b sw-engine pipeline": phase_sw_engine(workdir, MC, AC)}
    log(f"  sw engine on the card: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, paths["phase b bench correction"] = bench_correction_path(cli, MC)
    log(f"  bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, paths["phase b correct --profile"] = phase_profile(cli, workdir, MC)
    log(f"  profile and count: {time.perf_counter() - t0:.1f} s")
    log(f"  phase b: {time.perf_counter() - tb:.1f} s")
    return paths


# ---------------------------------------------------------------- phase c

def carry_chain(MC, M, args, cuts, window=None):
    """K1''s carried-state mode over consecutive column chunks of widths
    `cuts` from a fresh state, through its wrapper (windows by shape) or,
    kernel alone, at windows of `window` owned columns where a chunk is
    longer; returns (state, MyersResult)."""
    q, t, ql, tl = args
    W = M.n_words(q.shape[1])
    st = M.myers_init_state(ql, W)
    j0, res = 0, None
    for c in cuts:
        chunk = t[:, j0:j0 + c].contiguous()
        if window is None:
            st, res = MC.myers_cols_cuda(q, chunk, ql, tl, st, j0)
        else:
            *ops, outs = MC.carry_operands(q, chunk, ql, tl, st, j0,
                                           window=window)
            MC.run_carry_kernel(*ops, outs)
            st, res = M.unpack_state(outs[0], W), MC.MyersResult(*outs[1:])
        j0 += c
    return st, res


def chunk_cuts(Lt: int, n: int, rng):
    """`n` uneven chunk widths that sum to Lt."""
    import numpy as np

    inner = np.sort(rng.choice(np.arange(1, Lt), n - 1, replace=False))
    return np.diff(np.concatenate([[0], inner, [Lt]])).tolist()


def phase_carry(rng, MC, M):
    """Phase c, part 1: K1''s carried-state mode (myers_cols_cuda) ==
    ops/myers.myers_cols, bit-exact (state words, score, best, bj, dist,
    tend), at segment_identity's shape (W 13, one shared row) and the
    long-overlap shape (W 14, per-pair rows) and at the edges (qlen 0, 1,
    31, 32, tlen inside a later chunk, codes -1, 4, 9); chained over 2, 3
    and 8 chunks (and 1, 31, 32, 1024, 1025, ... columns) == one chunk ==
    one-shot K1' (myers_batch_cuda).  myers_batch_cuda_carry must move."""
    import torch

    log("phase c: K1''s carried-state mode vs myers_cols, bit-exact")
    errs = []
    before = launch_counts()["myers_batch_cuda_carry"]
    cases = [("segment_identity shape (W 13, shared row, 4 kb genome: "
              "Lt 8001)", segment_inputs(rng, 4_000)),
             ("long-overlap shape (W 14, per-pair rows: N 4096, Lq 414, "
              "Lt 478)", myers_edges(rng, 4096, 414, 478)),
             ("shared-row edges (W 4: N 1000, Lq 112, Lt 3000)",
              shared_edges(rng, 1000, 112, 3000)),
             ("per-pair edges (W 1: N 1024, Lq 20, Lt 64)",
              myers_edges(rng, 1024, 20, 64))]
    for label, x in cases:
        errs += carry_case(rng, MC, M, label, x)
    moved = launch_counts()["myers_batch_cuda_carry"] - before
    if moved <= 0:
        fail("myers_batch_cuda_carry did not count")
    log(f"  myers_batch_cuda_carry moved by {moved}")
    return max(errs)


def carry_case(rng, MC, M, label, x):
    """One case of the carried-state mode: one chunk == myers_cols (state
    and result) == one-shot K1', and chains over 2, 3 and 8 chunks (and 1,
    31, 32, 1024, 1025, ... columns where Lt allows) == one chunk."""
    import torch

    errs = []
    args = to_dev(*x)
    q, t, ql, tl = args
    W, Lt = M.n_words(q.shape[1]), t.shape[1]
    t0 = time.perf_counter()
    ref = M.myers_cols(*M.query_planes(q, ql, W), t, tl,
                       M.myers_init_state(ql, W))
    torch.cuda.synchronize()
    log(f"  plain myers_cols ({label}): {time.perf_counter() - t0:.1f} s")
    one = MC.myers_batch_cuda(*args)
    st, res = MC.myers_cols_cuda(*args, M.myers_init_state(ql, W))
    log(f"  carry {label}: {MC.carry_operands(*args, st)[4].S} windows by "
        "shape")
    for f, a, b in zip(("pv", "mv", "score", "best", "bj"), st, ref):
        errs.append(eq(f"carry {label}: {f}", a, b))
    ref_res = M.state_result(ql, ref)
    for f in ("dist", "tend"):
        errs.append(eq(f"carry {label}: {f} vs plain", getattr(res, f),
                       getattr(ref_res, f)))
        errs.append(eq(f"carry {label}: {f} vs one-shot K1'",
                       getattr(res, f), getattr(one, f)))
    splits = [chunk_cuts(Lt, n, rng) for n in (2, 3, 8)]
    if Lt > 2113:
        splits.append([1, 31, 32, 1024, 1025, Lt - 2113])
    H = M.window_halo(W)
    runs = [(cuts, None) for cuts in splits]
    if Lt > H:
        # forced windows of one halo: one chunk, and chained over 2 and 3
        runs += [([Lt], H), (splits[0], H), (splits[1], H)]
    for cuts, window in runs:
        st_c, res_c = carry_chain(MC, M, args, cuts, window)
        tag = (f"carry {label} over {len(cuts)} chunks"
               + (f" at windows of {window}" if window else ""))
        errs += [eq(f"{tag}: state", torch.stack([x.flatten() for x in
                                                  st_c[2:]]),
                    torch.stack([x.flatten() for x in st[2:]])),
                 eq(f"{tag}: pv, mv", torch.cat(st_c[:2], 1),
                    torch.cat(st[:2], 1)),
                 eq(f"{tag}: dist", res_c.dist, one.dist),
                 eq(f"{tag}: tend", res_c.tend, one.tend)]
    return errs


def phase_carry_wide(rng, MC, M):
    """Phase 2's carried-state cases at W 26 and W 33 (the last lane's
    spare word past the query: per-pair rows, N 2048, Lt = Lq + 72), and
    on the wide route at W 48 (per-pair rows) and W 40 (a shared row of
    6,000 columns: windows); myers_batch_cuda_carry must move."""
    before = launch_counts()["myers_batch_cuda_carry"]
    errs = []
    for lq in (800, 1023, 1488):
        errs += carry_case(
            rng, MC, M, f"W {M.n_words(lq)} (per-pair rows: N 2048, Lq {lq}, "
            f"Lt {lq + 72})", myers_edges(rng, 2048, lq, lq + 72,
                                          edges=(0, 1, 744, 745, 775, 993,
                                                 1023, lq)))
    errs += carry_case(rng, MC, M, "W 40 (shared row: N 200, Lq 1240, "
                       "Lt 6000)", shared_edges(rng, 200, 1240, 6000))
    if launch_counts()["myers_batch_cuda_carry"] <= before:
        fail("myers_batch_cuda_carry did not count at W 26, 33, 40, 48")
    return max(errs)


def _w_distributed(reads: str, outdir: str, genome_fa: str):
    """One rank of phase c's two (launched by parallel/launch.py): the
    judged pipeline on the world, then segment_identity of its contigs
    through the ring; launches, stage seconds and WORK of this rank."""
    import torch

    from hga_tpu_torch import convert
    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.io.fastq import iter_records
    from hga_tpu_torch.models.pipeline import run_pipeline
    from hga_tpu_torch.ops import myers_cuda as MC
    from hga_tpu_torch.parallel import hostpart as HP
    from hga_tpu_torch.parallel.mesh import make_mesh
    from hga_tpu_torch.utils.evalx import segment_identity

    pr_s = convert.load_corrected(os.path.join(reads, "short.npz"))
    pr_l = convert.load_corrected(os.path.join(reads, "long.npz"))
    zero_launches()
    arb = {}
    t0 = time.perf_counter()
    with stage_launches(arb):
        res = run_pipeline(pr_s, pr_l, judged_cfg(),
                           os.path.join(outdir, f"run{HP.pid()}"),
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    genome = "".join(r.seq for r in iter_records(genome_fa))
    zero_launches()
    t1 = time.perf_counter()
    seg = segment_identity(res.polished, genome, device="cuda",
                           mesh=make_mesh())
    torch.cuda.synchronize()
    seg["seconds"] = round(time.perf_counter() - t1, 3)
    return dict(pipeline_s=round(wall, 3), launches=launches,
                arbitrate_launches=arb, work=dict(HP.WORK),
                stage_s={k: v["seconds"]
                         for k, v in res.stats["stages"].items()},
                correction_detail=res.stats.get("correction_detail"),
                overlaps=res.stats.get("overlaps"),
                segments=seg, segment_launches=launch_counts())


def run_cli(argv, nproc: int = 0, timeout: int = 600):
    """`hga-torch` as a user runs it: in a subprocess, or under torchrun
    with `nproc` ranks; returns (the JSON object it printed last, the
    combined output)."""
    import subprocess

    cmd = [sys.executable, "-m", "hga_tpu_torch.cli", *argv]
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m", "hga_tpu_torch.cli",
               *argv]
    p = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        fail(f"{' '.join(argv)} ({nproc} ranks) exited {p.returncode}: "
             f"{p.stderr[-3000:]}")
    last = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return json.loads(last[-1]), p.stdout + p.stderr


def phase_distributed(genome_len: int, workdir: str, p4: dict):
    """Phase c, parts 2-5: two ranks on the one card (gloo; NCCL refuses
    two ranks on a card): the judged pipeline against phase 4's one-rank
    artifacts, segment_identity through the ring against one rank.
    Returns {path: launches} and the arguments of phase_c_cli."""
    import numpy as np

    from hga_tpu_torch.io.fastq import write_fasta
    from hga_tpu_torch.models.correction import MAX_VOTE_COLS, length_groups
    from hga_tpu_torch.parallel.launch import launch
    from hga_tpu_torch.utils.evalx import segment_identity

    tc = time.perf_counter()
    genome, pr_s, pr_l = simulate(genome_len, 42)
    reads = os.path.join(workdir, "c_reads")
    os.makedirs(reads)
    pr_s.save(os.path.join(reads, "short.npz"))
    pr_l.save(os.path.join(reads, "long.npz"))
    genome_fa = os.path.join(workdir, "c_genome.fasta")
    contigs_fa = os.path.join(workdir, "c_contigs.fasta")
    write_fasta(genome_fa, [("genome", genome)])
    write_fasta(contigs_fa, p4["polished"])
    log(f"phase c: run_pipeline on 2 ranks sharing the card (gloo), "
        f"{genome_len} bp genome")
    out = os.path.join(workdir, "c_ranks")
    t0 = time.perf_counter()
    ranks = launch("chip_smoke:_w_distributed", 2, out,
                   dict(reads=reads, outdir=out, genome_fa=genome_fa),
                   device="cuda", threads=4, pythonpath=[HERE],
                   timeout=900)
    wall = time.perf_counter() - t0
    for r, o in enumerate(ranks):
        if o["jax_loaded"] or o["hga_tpu_loaded"] or o["backend"] != "gloo":
            fail(f"rank {r}: {o['backend']}, jax {o['jax_loaded']}, "
                 f"hga_tpu {o['hga_tpu_loaded']}")
        log(f"  rank {r}: " + json.dumps({k: o[k] for k in (
            "pipeline_s", "stage_s", "work", "launches",
            "arbitrate_launches", "correction_detail", "overlaps")}))
        for name in ("myers_batch_cuda", "myers_votes_cuda"):
            if o["launches"].get(name, 0) <= 0:
                fail(f"rank {r}: {name} never launched in the pipeline")
        if k2v_launches(o["arbitrate_launches"]) <= 0:
            fail(f"rank {r}: K2' never launched in the arbitrate stage")
    log(f"  two ranks: {wall:.1f} s wall (launch included); phase 4, one "
        f"rank: {p4['out']['pipeline_s']} s, stages "
        f"{json.dumps(p4['out']['stage_s'])}")
    # artifacts: rank 0 wrote them, rank 1 nothing
    d2, d1 = os.path.join(out, "run0"), p4["dir"]
    if os.listdir(os.path.join(out, "run1")):
        fail("rank 1 wrote artifacts")
    same_outputs({"2 ranks": d2, "1 rank (phase 4)": d1},
                 ("contigs.fasta", "assembly.gfa", "arbitrated.fasta",
                  "polished.fasta"), ("corrected.npz", "overlaps.npz"))
    s2 = np.load(os.path.join(d2, "spectrum.npz"))
    s1 = np.load(os.path.join(d1, "spectrum.npz"))
    solid = s2["count"] >= s2["threshold"]
    for k, a, b in (("hist", s2["hist"], s1["hist"]),
                    ("threshold", s2["threshold"], s1["threshold"]),
                    ("solid hi", s2["hi"][solid], s1["hi"]),
                    ("solid lo", s2["lo"][solid], s1["lo"]),
                    ("solid count", s2["count"][solid], s1["count"])):
        if not np.array_equal(a, b):
            fail(f"spectrum.npz {k}: 2 ranks differ from 1")
    log(f"  ok: spectrum.npz hist, threshold and solid set equal "
        f"({int(solid.sum())} solid of {s2['hi'].size} distinct on 2 ranks)")
    # WORK: the whole, split per block_range
    n_long = pr_l.n_reads
    groups = length_groups(pr_l.length, MAX_VOTE_COLS)
    want = {"corr_backbones": [sum(len(g) // 2 + (r < len(g) % 2)
                                   for g in groups) for r in range(2)],
            "long_query_reads": [n_long // 2 + (r < n_long % 2)
                                 for r in range(2)]}
    for key, w in want.items():
        got = [o["work"].get(key, 0) for o in ranks]
        if got != w:
            fail(f"WORK {key}: {got}, block_range gives {w}")
    log(f"  ok: WORK split per block_range: {json.dumps(want)}")
    paths = {f"phase c 2-rank pipeline, rank {r}": o["launches"]
             for r, o in enumerate(ranks)}

    # segment_identity: the ring on 2 ranks, one rank here
    one = segment_identity(p4["polished"], genome, device="cuda")
    for r, o in enumerate(ranks):
        seg = o["segments"]
        log(f"  rank {r} segment_identity (ring): {json.dumps(seg)}; "
            f"launches {json.dumps(o['segment_launches'])}")
        if seg["segment_dist"] != one["segment_dist"]:
            fail(f"ring segment_dist {seg['segment_dist']} != one rank's "
                 f"{one['segment_dist']}")
        if o["segment_launches"].get("myers_batch_cuda_carry", 0) <= 0:
            fail(f"rank {r}: the ring did not launch the carried-state mode")
        paths[f"phase c ring segment_identity, rank {r}"] = \
            o["segment_launches"]
    log(f"  ok: segment_dist {one['segment_dist']} on 2 ranks == 1 rank "
        f"({one['n_segments']} segments)")
    log(f"  phase c distribution: {time.perf_counter() - tc:.1f} s")
    return paths, (contigs_fa, genome_fa, one["segment_dist"])


def phase_c_cli(contigs_fa: str, genome_fa: str, segment_dist: int) -> list:
    """Phase c, part 5: the CLI under torchrun, as a user runs it: `eval
    --segs` on a world of 1 (NCCL) against one rank's segment_dist, `bench
    --what scaling` on 1 (NCCL) and 2 (gloo) ranks, `bench --what comm`.
    Each is a process of its own, so main runs this in a thread beside
    phases b and d, whose scripts take this process's standard output: the
    lines are returned, for main to log once phase d has ended."""
    lines = []
    tc = time.perf_counter()
    t0 = time.perf_counter()
    got, text = run_cli(["eval", "--contigs", contigs_fa, "--reference",
                         genome_fa, "--segs"], nproc=1)
    if "backend nccl" not in text:
        fail("torchrun --nproc-per-node 1 did not take NCCL")
    if got["segment_dist"] != segment_dist:
        fail(f"eval --segs on NCCL: {got['segment_dist']} != "
             f"{segment_dist}")
    lines.append(f"  ok: torchrun --nproc-per-node 1 eval --segs on NCCL: "
        f"segment_dist {got['segment_dist']} ({time.perf_counter() - t0:.1f}"
        " s)")

    bench = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        bench[n], text = run_cli(["bench", "--what", "scaling"], nproc=n)
        want = "nccl" if n == 1 else "gloo"
        if f"backend {want}" not in text:
            fail(f"bench --what scaling on {n} ranks did not take {want}")
        lines.append(f"  bench --what scaling, {n} rank(s) ({want}): "
            f"{json.dumps(bench[n])} ({time.perf_counter() - t0:.1f} s)")
    if "not a scaling figure" not in bench[2].get("note", ""):
        fail("the 2-rank scaling figure does not say it shares one card")
    comm, _ = run_cli(["bench", "--what", "comm"])
    lines.append(f"  bench --what comm: {json.dumps(comm)}")
    lines.append(f"  phase c CLI: {time.perf_counter() - tc:.1f} s")
    return lines


@contextlib.contextmanager
def script_logging():
    """The scripts call logging.basicConfig(level=INFO); a root handler at
    WARNING set first makes that a no-op, so the pipeline's INFO lines stay
    out of this script's output.  The root's handlers are restored."""
    import logging

    root = logging.getLogger()
    saved = root.handlers[:]
    h = logging.StreamHandler(sys.stderr)
    h.setLevel(logging.WARNING)
    root.handlers = [h]
    try:
        yield
    finally:
        root.handlers = saved


def run_script(name: str, argv, MC, show: int = 40):
    """`python -m hga_tpu_torch.exp.<name> argv...` in this process: its
    main(argv), with the launch counters set to 0 just before and read just
    after.  Returns (what main returned, its standard output, the
    launches)."""
    import importlib

    import torch

    mod = importlib.import_module(f"hga_tpu_torch.exp.{name}")
    zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), script_logging():
        ret = mod.main(list(argv))
    torch.cuda.synchronize()
    launches = launch_counts()
    text = buf.getvalue()
    lines = text.splitlines()
    log(f"  {' '.join([name, *argv])}: {time.perf_counter() - t0:.1f} s, "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    for ln in lines[:show]:
        log(f"    | {ln}")
    if len(lines) > show:
        log(f"    | ... ({len(lines) - show} more lines)")
    return ret, text, launches


def start_script(name: str, argv, out: str, env=None):
    """`python -m hga_tpu_torch.exp.<name> argv...` in a subprocess of its
    own, its output to the file `out`; returns (Popen, out)."""
    import subprocess

    with open(out, "w") as fh:
        p = subprocess.Popen(
            [sys.executable, "-m", f"hga_tpu_torch.exp.{name}", *argv],
            cwd=HERE, stdout=fh, stderr=subprocess.STDOUT,
            env=dict(os.environ, **(env or {})))
    return p, out


def wait_script(name: str, proc, out: str) -> str:
    try:
        rc = proc.wait(timeout=600)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    text = open(out).read()
    if rc:
        fail(f"python -m hga_tpu_torch.exp.{name} exited {rc}: "
             f"{text[-3000:]}")
    return text


def phase_scripts(genome_len: int, workdir: str, p4: dict, MC):
    """Phase d: the exp/ scripts of hga_tpu_torch.exp as a user runs them,
    on a copy of phase 4's run directory and on a DIAG_GENOME repeat
    genome.  Four run as `python -m` in processes of their own, started
    first and run beside the rest: scale_run --repeats (diag_polish_votes'
    contig), count_scale --device cpu, and the two that launch no counted
    kernel, asm_sweep and diag_leak.  The others run here, their launch
    counters read.  Returns {path: launches}."""
    import torch

    td = time.perf_counter()
    gmb = str(genome_len / 1e6)
    cmb = str(COUNT_GENOME / 1e6)
    rep_kb = str(DIAG_GENOME // 1000)
    d = os.path.join(workdir, "d_run")
    shutil.copytree(p4["dir"], d)
    log(f"phase d: the exp/ scripts on a copy of phase 4's run "
        f"({genome_len} bp) and a {DIAG_GENOME} bp repeat genome")
    paths = {}

    # bench_corr_tb first, alone on the card: its times
    ret, _, L = run_script("bench_corr_tb", [], MC)
    paths["phase d bench_corr_tb"] = L
    for name in ("myers_batch_planes_cuda", "myers_votes_cuda"):
        if L[name] <= 0:
            fail(f"bench_corr_tb did not launch {name}")
    # less the sink slot, which the plain traceback writes and K2' not
    m = {k: v[:-1] for k, v in ret["merged"].items()}
    if not (torch.equal(m["fused_full_S"], m["fused_bounded"])
            and torch.equal(m["fused_full_S"], m["dp_only"])):
        fail("bench_corr_tb: the vote buffers of fused_full_S, "
             "fused_bounded and the K2 planes' traceback differ")
    log(f"  ok: bench_corr_tb's three vote buffers equal ({ret['gated']} of "
        f"{ret['P']} random pairs gated; planted: {ret['planted_gated']}, "
        f"{int(m['fused_full_S'].sum())} votes); ms "
        f"{json.dumps(ret['ms'])}")

    rep_dir = os.path.join(workdir, "d_rep")
    cjson = {dv: os.path.join(workdir, f"d_count_{dv}.json")
             for dv in ("cuda", "cpu")}
    bg = {}
    for label, argv, env in (
            ("scale_run", [str(DIAG_GENOME / 1e6), rep_dir, "--repeats"], {}),
            ("count_scale", [cmb, cjson["cpu"], "--device", "cpu"],
             {"OMP_NUM_THREADS": "2"}),
            ("asm_sweep", [d, gmb, "42"], {}),
            ("diag_leak", [rep_kb], {})):
        bg[label] = start_script(label, argv,
                                 os.path.join(workdir, f"d_{label}.log"), env)
    try:
        paths.update(scripts_here(d, gmb, cmb, rep_kb, workdir, MC, cjson))
        outs = {k: wait_script(k, *v) for k, v in bg.items()}
    finally:
        for proc, _ in bg.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    rows = [json.loads(ln) for ln in outs["asm_sweep"].splitlines()
            if ln.startswith("{")]
    log("  asm_sweep (python -m): " + "; ".join(
        f"{r['variant']} {r['n_contigs']} contigs, identity "
        f"{r['identity']:.6f}" for r in rows))
    n_contigs = json.load(open(os.path.join(
        workdir, "d_reoverlap", "reoverlap_metrics.json")))["n_contigs"]
    if len(rows) != 9 or "FAILED" in outs["asm_sweep"]:
        fail(f"asm_sweep printed {len(rows)} of 9 variants")
    if rows[0]["variant"] != "base" or rows[0]["n_contigs"] != n_contigs:
        fail(f"asm_sweep base: {rows[0]['n_contigs']} contigs, reoverlap "
             f"{n_contigs}")
    leak = outs["diag_leak"].splitlines()
    log("  diag_leak (python -m): " + " | ".join(leak[:4]))
    if not any("misplaced" in ln for ln in leak):
        fail("diag_leak printed no misplaced count")

    # the contigs diag_polish_votes probes; on a repeat genome this small
    # (seven 5 kb rRNA copies in 100 kb) identity is not held to 0.99
    rep = json.load(open(os.path.join(rep_dir, "scale_metrics.json")))
    log(f"  scale_run {DIAG_GENOME / 1e6} --repeats (python -m): "
        + json.dumps(rep["eval"]))
    if rep["eval"]["n_contigs"] < 1:
        fail("scale_run --repeats produced no contig")
    _, text, L = run_script(
        "diag_polish_votes", [os.path.join(rep_dir, "contigs.fasta"), rep_kb],
        MC)
    paths["phase d diag_polish_votes"] = L
    if L["myers_votes_cuda"] <= 0 or "votes at sites" not in text:
        fail("diag_polish_votes did not polish on K2'")

    got = {dv: json.load(open(p)) for dv, p in cjson.items()}
    keys = ("distinct_kmers", "solid_threshold", "n_reads")
    if any(got["cuda"][k] != got["cpu"][k] for k in keys):
        fail(f"count_scale {cmb} Mb: card {[got['cuda'][k] for k in keys]} "
             f"!= CPU {[got['cpu'][k] for k in keys]}")
    log(f"  ok: count_scale {cmb} Mb card == CPU: "
        + json.dumps({k: got["cuda"][k] for k in keys})
        + f"; seconds first / warm: card {got['cuda']['seconds_first']} / "
        f"{got['cuda']['seconds_warm']}, CPU {got['cpu']['seconds_first']} "
        f"/ {got['cpu']['seconds_warm']}")
    log(f"  phase d scripts: {time.perf_counter() - td:.1f} s")
    return paths


def scripts_here(d: str, gmb: str, cmb: str, rep_kb: str, workdir: str, MC,
                 cjson: dict):
    """Phase d's scripts in this process; returns {path: launches}."""
    paths = {}
    # reoverlap recomputes phase 4's overlaps and assembly from its
    # corrected reads: the same records and contigs.  Those contigs are
    # unpolished (--polish writes them and polishes nothing, as in the JAX
    # script), so identity >= 0.99 is required after polish_retry polishes
    # them, in reoverlap's directory.
    rov = os.path.join(workdir, "d_reoverlap")
    ret, _, L = run_script("reoverlap", [d, rov, gmb, "42", "--polish"], MC)
    paths["phase d reoverlap"] = L
    if L["myers_batch_cuda"] <= 0:
        fail("reoverlap did not launch K1'")
    same_outputs({"reoverlap": rov, "phase 4": d}, ("contigs.fasta",),
                 ("overlaps.npz",))
    log(f"  reoverlap's (unpolished) contigs: identity {ret['identity']}")

    ret, _, L = run_script("polish_retry", [rov, "2", gmb, "42"], MC)
    paths["phase d polish_retry"] = L
    if L["myers_votes_cuda"] <= 0:
        fail("polish_retry did not launch K2'")
    for k, v in ret.items():
        if v["identity"] < 0.99:
            fail(f"polish_retry {k}: k-mer identity {v['identity']:.5f} "
                 "< 0.99")

    _, _, L = run_script("count_scale", [cmb, cjson["cuda"]], MC)
    paths["phase d count_scale"] = L
    _, text, L = run_script("diag_false_ov", [d], MC, show=12)
    paths["phase d diag_false_ov"] = L
    if not text.startswith("records: "):
        fail("diag_false_ov printed no record count")
    _, text, L = run_script("diag_graph", [d], MC, show=8)
    paths["phase d diag_graph"] = L
    if "cleaned" not in text:
        fail("diag_graph did not reach the cleaned graph")
    _, text, L = run_script("diag_repeat_corr", [rep_kb], MC)
    paths["phase d diag_repeat_corr"] = L
    if L["myers_votes_cuda"] <= 0 or "[corr ON]" not in text:
        fail("diag_repeat_corr did not correct on K2'")
    return paths


def read_loci(names):
    """Truth loci from simulated read names (utils/sim.py):
    sr_{i}_{start}_{strand} and lr_{i}_{start}_{strand}_{len}."""
    import numpy as np

    f = [n.split("_") for n in names]
    start = np.array([int(x[2]) for x in f], np.int64)
    strand = np.array([int(x[3]) for x in f], np.int64)
    length = np.array([int(x[4]) if len(x) > 4 else 0 for x in f], np.int64)
    return start, strand, length


def phase_config3(genome_len: int, MC, AC, read_len: int = 100,
                  seed: int = 42, band: Optional[int] = None):
    """Judged config 3 on the card: short reads of the judged read model
    against its long reads, refine sw; precision against the truth loci.
    The refine's width (the short reads' pad) and band (`band`, as
    `--band` sets it; the judged 64 by default) pick the SW routes of the
    forward pass and of the reverse pass at twice the band: K3' at 100 bp
    reads (pad 112), K3'' at 300 bp reads (pad 320, forward band 64 and
    reverse band 128 both on it), K3'' forward and K3''' reverse at 300 bp
    and band 128 (reverse band 256); those counters must move and the
    others (K3's rows among them) stay at 0.  The 100 bp drive counts a
    record right when
    the short read lies inside its long read's locus; at 300 bp about 5%
    of true overlaps hang off a long read's end (a read-length share of the
    ~8 kb long reads), so that drive counts a record right when the two
    loci touch.  Both need rel = the strands' xor."""
    import numpy as np
    import torch

    from hga_tpu_torch.models import overlap as OV

    log(f"phase 8: config 3 (compute_overlaps_cross, refine sw) on a "
        f"{genome_len} bp genome, {read_len} bp short reads")
    t0 = time.perf_counter()
    _, pr_s, pr_l = simulate(genome_len, seed, read_len)
    cfg = config3_cfg() if band is None else config3_cfg().replace(band=band)
    routes = config3_routes(AC, pr_s.pad_len, cfg.band)
    log(f"  {pr_s.n_reads} short (pad {pr_s.pad_len}, band {cfg.band}: SW "
        f"routes {sorted(routes)}) + {pr_l.n_reads} long reads "
        f"({time.perf_counter() - t0:.1f} s to simulate or reuse)")
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = OV.compute_overlaps_cross(pr_s, pr_l, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for name in ("myers_batch_cuda",
                 *(AC.ROUTE_COUNTER[r] for r in routes)):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the config-3 path")
    for kind, name in AC.ROUTE_COUNTER.items():
        if kind not in routes and launches[name]:
            fail(f"{name} ran {launches[name]} times at the {routes} routes' "
                 "widths")
    if rec.n == 0:
        fail("config 3 found no overlap")
    s_start, s_strand, _ = read_loci(pr_s.names)
    l_start, l_strand, l_len = read_loci(pr_l.names)
    a, b = rec.a.astype(np.int64), rec.b.astype(np.int64)
    a0, b0 = s_start[a], l_start[b]
    inside = (b0 <= a0) & (a0 + pr_s.length[a] <= b0 + l_len[b])
    strands = rec.rel == (s_strand[a] ^ l_strand[b])
    touching = (np.minimum(a0 + pr_s.length[a], b0 + l_len[b])
                - np.maximum(a0, b0)) > 0
    t = OV.LAST_TIMINGS
    out = dict(genome_len=genome_len, read_len=read_len, band=cfg.band,
               n_short=pr_s.n_reads, n_long=pr_l.n_reads,
               candidates=t["gate_pairs"],
               survivors=t["refine_pairs"], records=rec.n,
               gate_s=t["gate_s"], refine_s=t["refine_s"],
               overlaps_s=round(wall, 3),
               precision=round(float((inside & strands).mean()), 6),
               precision_touching=round(float((touching & strands).mean()),
                                        6),
               peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
               launches=launches)
    log("  config 3: " + json.dumps(out))
    judged = "precision" if read_len == 100 else "precision_touching"
    if out[judged] < 0.95:
        fail(f"config-3 {judged} {out[judged]} < 0.95: records must pair a "
             "short read with a long read at its locus, rel = the strands' "
             "xor")
    return launches, out


def config3_routes(AC, pad: int, band: int) -> set:
    """The SW routes of config 3's refine at a short-read pad: the forward
    pass (Lq = pad, Lt = pad + band + 8, models/overlap) at `band`, the
    reverse pass at 2 band."""
    return {AC.route(pad, pad + band + 8, b).kind for b in (band, 2 * band)}


def time_row(shape, wrapper, sets, kernel, kernel_sets, plain, cells, ops,
             nbytes, plain_ms=None):
    """CUDA-event times of a wrapper and of its kernel alone (20 calls over
    distinct input sets, warm) and of the plain version (one call, or
    `plain_ms` where the caller timed that call), the bound from `ops`
    int32 operations and `nbytes` bytes and the kernel's share of it, GCUPS
    on `cells` (no plain time where `plain` is None).  Launches made here are no path's: the counters are
    restored."""
    from hga_tpu_torch.utils import benchmarks as B

    before = launch_counts()
    ms = B.cuda_ms(wrapper, sets, 20)
    kern_ms = B.cuda_ms(kernel, kernel_sets, 20)
    if plain_ms is None and plain is not None:
        plain_ms = one_call_ms(plain, sets[0])
    restore(before)
    bound, by = B.bound_ms(ops, nbytes)
    row = dict(shape=shape, ms=ms, kernel_ms=kern_ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by,
               pct_of_bound=100 * bound / kern_ms)
    if cells:
        row.update(cells=int(cells), gcups=cells / (ms * 1e-3) / 1e9,
                   kernel_gcups=cells / (kern_ms * 1e-3) / 1e9)
    return row


def one_call_ms(fn, args) -> float:
    """One call of a plain version on the host clock, to a synchronize (it
    is host-bound: a few torch operations a target column)."""
    import torch

    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def myers_cost(N, Lq, Lt, planes):
    """(cells, int32 operations, bytes) of one Myers launch: Lq x Lt cells,
    20 operations per word and column, codes and lengths read once, dist
    and tend (and K2's planes) written once."""
    from hga_tpu_torch.ops.myers import n_words
    from hga_tpu_torch.utils import benchmarks as B

    W = n_words(Lq)
    out_bytes = 8 * N + (2 * 4 * Lt * N * W if planes else 0)
    return (N * Lq * Lt, N * Lt * W * B.OPS_PER_WORD_COLUMN,
            4 * N * (Lq + Lt) + 8 * N + out_bytes)


def gate_row(MC, M, sets):
    """K1' at one shape: the wrapper (GATE_GROUP's design) and, kernel
    alone, each of the two designs (G 1 and G = group_width(W))."""
    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    W, G = M.n_words(Lq), MC.GATE_GROUP[M.n_words(Lq)]
    cells, ops, nbytes = myers_cost(N, Lq, Lt, False)
    row = time_row(dict(N=N, Lq=Lq, Lt=Lt, W=W, G=G), MC.myers_batch_cuda,
                   sets, MC.run_kernel,
                   [MC.kernel_operands(*a, group=G) for a in sets],
                   M.myers_batch, cells, ops, nbytes)
    row.update(zip(("registers", "local_bytes"), MC.kernel_attrs(W, group=G)),
               blocks=MC.gate_blocks(N, G), designs={})
    for g in MC.gate_designs(W):
        ms = B.cuda_ms(MC.run_kernel,
                       [MC.kernel_operands(*a, group=g) for a in sets], 20,
                       passes=3)
        regs, local = MC.kernel_attrs(W, group=g)
        row["designs"][f"G{g}"] = dict(
            kernel_ms=ms, pct_of_bound=100 * row["bound_ms"] / ms,
            kernel_gcups=cells / (ms * 1e-3) / 1e9, registers=regs,
            local_bytes=local, blocks=MC.gate_blocks(N, g))
    return row


def shared_row(rng, MC, M, genome_len: int):
    """K1''s shared-target mode at segment_identity's shape on a genome of
    `genome_len` (N segments of 384 against Lt = 2 genome_len + 1): the
    wrapper and the kernel alone, 3 launches each after a warm-up over 2
    input sets; the plain version walks its columns in Python and cannot
    run there, so it is timed, beside the wrapper and kernel, at a cut
    shape (a 2 kb genome: Lt 4001).  Bounds: N Lt W 20 operations, each
    code and length read once (the row once), dist and tend written."""
    from hga_tpu_torch.utils import benchmarks as B

    def cost(sets):
        N, Lq = sets[0][0].shape
        Lt, W = sets[0][1].shape[1], M.n_words(Lq)
        return (dict(N=N, Lq=Lq, Lt=Lt, W=W, G=MC.GATE_GROUP[W]),
                N * Lt * W * B.OPS_PER_WORD_COLUMN,
                4 * N * Lq + 4 * Lt + 8 * N + 8 * N)

    cut = [to_dev(*segment_inputs(rng, 2000)) for _ in range(2)]
    shape, ops, nbytes = cost(cut)
    cut_row = time_row(shape, MC.myers_batch_cuda, cut, MC.run_kernel,
                       [MC.kernel_operands(*a) for a in cut], M.myers_batch,
                       0, ops, nbytes)
    full = [to_dev(*segment_inputs(rng, genome_len)) for _ in range(2)]
    shape, ops, nbytes = cost(full)
    before = launch_counts()
    ms = B.cuda_ms(MC.myers_batch_cuda, full, 3)
    restore(before)
    row = dict(shape=shape, ms=ms, plain_ms=cut_row["plain_ms"],
               plain_shape=cut_row["shape"], cut_shape=cut_row)
    row.update(window_times(MC, M, full, ops, nbytes, MC.kernel_operands,
                            MC.run_kernel, lambda a: dict(window=a)))
    return row


def carry_row(rng, MC, M, genome_len: int, P: int = 2):
    """K1''s carried-state mode at the ring's step shape on P ranks of
    segment_identity on a genome of `genome_len`: one rank's block (N / 2P
    segments of 384, W 13) against its chunk (Lt / P columns of the shared
    row), from a fresh state; the wrapper (state packing included) and the
    kernel alone, 3 launches each after a warm-up over 2 input sets; the
    plain version at a cut shape (a 2 kb genome).  Bound: N C W 20
    operations; codes, lengths and the chunk read once, the state read and
    written once, dist and tend written."""
    from hga_tpu_torch.utils import benchmarks as B

    def sets_of(g):
        out = []
        for _ in range(2):
            q, t, ql, tl = segment_inputs(rng, g)
            Lt = -(-t.shape[1] // P) * P
            B = max(2 * P, 8)             # segment_identity's padding
            NB = -(-q.shape[0] // B) * B // (2 * P)   # one of 2 P blocks
            q, ql, tl = q[:NB], ql[:NB], tl[:NB]
            a = to_dev(q, t[:, :Lt // P].copy(), ql, tl)
            out.append((*a, M.myers_init_state(a[2], M.n_words(q.shape[1]))))
        return out

    def cost(sets):
        (N, Lq), C = sets[0][0].shape, sets[0][1].shape[1]
        W = M.n_words(Lq)
        return (dict(N=N, Lq=Lq, C=C, W=W, G=MC.GATE_GROUP[W], P=P),
                N * C * W * B.OPS_PER_WORD_COLUMN,
                4 * N * Lq + 4 * C + 8 * N + 2 * 4 * N * (2 * W + 3) + 8 * N)

    plain = lambda q, t, ql, tl, st: M.myers_cols(
        *M.query_planes(q, ql, M.n_words(q.shape[1])), t, tl, st)
    cut = sets_of(2000)
    shape, ops, nbytes = cost(cut)
    cut_row = time_row(shape, MC.myers_cols_cuda, cut, MC.run_carry_kernel,
                       [MC.carry_operands(*a) for a in cut], plain, 0, ops,
                       nbytes)
    full = sets_of(genome_len)
    shape, ops, nbytes = cost(full)
    before = launch_counts()
    ms = B.cuda_ms(MC.myers_cols_cuda, full, 3)
    restore(before)
    row = dict(shape=shape, ms=ms, plain_ms=cut_row["plain_ms"],
               plain_shape=cut_row["shape"], cut_shape=cut_row)
    row.update(window_times(MC, M, full, ops, nbytes, MC.carry_operands,
                            MC.run_carry_kernel,
                            lambda a: dict(j0=0, window=a)))
    return row


def window_times(MC, M, sets, ops, nbytes, operands, run, kw):
    """K1''s kernel alone on `sets` at the wrapper's windows (by shape), at
    twice as many, and at one window (the single sweep, S 1: the kernel
    before it had windows), 3 launches each after a warm-up; each one's
    S, warps launched an SM, share of the bound; kernel_ms is the
    wrapper's windows'.  The bound counts no halo: it is overhead, not
    work."""
    from hga_tpu_torch.utils import benchmarks as B

    bound, by = B.bound_ms(ops, nbytes)
    N, Lt = sets[0][0].shape[0], sets[0][1].shape[1]
    r = operands(*sets[0])[4]
    sms = MC._sms(sets[0][0].device)
    out = dict(bound_ms=bound, bound_by=by, windows={})
    for tag, window in (("by shape", None), ("twice the windows",
                                             max(-(-r.window // 2),
                                                 r.halo)),
                        ("one window (S 1)", Lt)):
        ops_sets = [operands(*a, **kw(window)) for a in sets]
        g = ops_sets[0][4]
        k_ms = B.cuda_ms(run, ops_sets, 3)
        out["windows"][tag] = dict(
            S=g.S, window=g.window, halo=g.halo, kernel_ms=k_ms,
            pct_of_bound=100 * bound / k_ms,
            warps_per_sm=g.S * -(-N // (32 // g.G)) / sms)
    main = out["windows"]["by shape"]
    regs, local = MC.kernel_attrs(r.W, windows=main["S"] > 1)
    out.update(kernel_ms=main["kernel_ms"], pct_of_bound=main["pct_of_bound"],
               S=main["S"], warps_per_sm=main["warps_per_sm"],
               registers=regs, local_bytes=local,
               blocks=MC.gate_blocks(N, r.G) * main["S"])
    return out


def wide_rows(rng, MC, M, PU):
    """K1''s wide route at the long reads' gate (N 4096 random pairs at Lq
    8,192 and 31,000, the pad a 4.6 Mb judged run gives its long reads,
    and W 35 and 100), wrapper and kernel alone (3 launches after a
    warm-up), its words in shared memory and (W 100) in the device scratch,
    the register route forced beside it at W 34; the plain version at a
    cut (N 16; Lq 31,000 takes Lq 8,192's); then K2''s wide route on
    planted correction batches at W 100 (pad 3,100, N 1,024: two launches
    under VOTES_SCRATCH_BYTES)."""
    import torch

    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.utils import benchmarks as B

    def sets_of(N, Lq, n=2):
        Lt = Lq + 72
        return [(torch.randint(0, 4, (N, Lq), dtype=torch.int32,
                               device="cuda"),
                 torch.randint(0, 4, (N, Lt), dtype=torch.int32,
                               device="cuda"),
                 torch.full((N,), Lq, dtype=torch.int32, device="cuda"),
                 torch.full((N,), Lt, dtype=torch.int32, device="cuda"))
                for _ in range(n)]

    rows = {}
    for name, Lq in (("Lq31000", 31_000), ("Lq8192", 8192), ("W100", 3100),
                     ("W35", 1085), ("W34", 1054)):
        sets = sets_of(4096, Lq)
        N, Lt = 4096, Lq + 72
        cells, ops, nbytes = myers_cost(N, Lq, Lt, False)
        before = launch_counts()
        reps = 3 if Lq > 4000 else 20
        ms = B.cuda_ms(MC.myers_batch_cuda, sets, reps)
        restore(before)
        variants = [("wide", dict(wide=True))]
        if name == "W100":
            variants.append(("wide, words in the scratch",
                             dict(words_scratch=True)))
        if name == "W34":
            variants.append(("register route", {}))
        bound, by = B.bound_ms(ops, nbytes)
        row = dict(shape=dict(N=N, Lq=Lq, Lt=Lt, W=M.n_words(Lq)), ms=ms,
                   bound_ms=bound, bound_by=by, cells=cells,
                   gcups=cells / (ms * 1e-3) / 1e9, variants={})
        for tag, kw in variants:
            ops_sets = [MC.kernel_operands(*a, **kw) for a in sets]
            k_ms = B.cuda_ms(MC.run_kernel, ops_sets, reps)
            r = ops_sets[0][4]
            row["variants"][tag] = dict(kernel_ms=k_ms,
                                        pct_of_bound=100 * bound / k_ms,
                                        wl=r.wl, smem=r.smem,
                                        scratch_words=r.words)
        row.update(kernel_ms=row["variants"]["wide"]["kernel_ms"],
                   pct_of_bound=row["variants"]["wide"]["pct_of_bound"])
        if Lq < 30_000:       # ~23 s a call at Lq 31,000: its cut's below
            row["plain_ms"] = one_call_ms(M.myers_batch,
                                          sets_of(16, Lq, 1)[0])
            row["plain_shape"] = dict(N=16, Lq=Lq, Lt=Lt)
        rows[name] = row
        log(f"  K1' wide route {name}: {json.dumps(row)}")
    main = rows.pop("Lq31000")
    main.update(plain_ms=rows["Lq8192"]["plain_ms"],
                plain_shape=rows["Lq8192"]["plain_shape"])
    main.update(zip(("registers", "local_bytes"),
                    MC.kernel_attrs(1000, wide=True)))
    main.update(rows)
    wide = [votes_inputs(rng, 1024, 3100, 64) for _ in range(2)]
    vrow, _, _ = votes_row(MC, PU, [to_dev(*ops)[:7] for ops, _, _ in wide],
                           wide[0][1], wide[0][2], judged_cfg().min_identity,
                           plain_sets=1)
    return main, vrow


def phase_times(rng, MC, M, PU, genome_len: int):
    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.models import correction as CR

    log("phase 6: kernel times (CUDA events, distinct inputs, warm)")
    rows = {}
    # K1' at the long-overlap shape (W 14), the config-3 gate (W 4), the
    # bench and harness shape (W 5) and W 1: both designs at each
    rows["myers_batch_cuda"] = gate_row(MC, M, [
        to_dev(*planted_pairs(rng, 4096, 414, 478)) for _ in range(4)])
    rows["myers_batch_cuda"]["gate_shape"] = gate_row(MC, M, [
        to_dev(*gate_inputs(rng)) for _ in range(4)])
    for name, lq in (("W5", 128), ("W1", 31)):
        rows["myers_batch_cuda"][name] = gate_row(MC, M, [
            to_dev(*planted_pairs(rng, 4096, lq, 192)) for _ in range(4)])
    # short reads padded to 800 (W 26), 992 (W 32) and 1024 (W 34, two words
    # a lane), the split design alone, against windows of Lq + 72
    for name, lq in (("W26", 800), ("W32", 992), ("W34", 1024)):
        rows["myers_batch_cuda"][name] = gate_row(MC, M, [
            to_dev(*planted_pairs(rng, 4096, lq, lq + 72))
            for _ in range(4)])
    # K2s at bench_corr_tb's shape (W 4) beside the forced K2 on the same
    # inputs, at W 13, 26 and 34 (Lt = Lq + 72; no plain call: 0.7-1.3 s
    # each on an H100, PERF.md), and on its wide route at W 100 (N 1,024:
    # 2.6 GB of planes a call)
    sets = [to_dev(*planted_pairs(rng, 4096, 112, 184)) for _ in range(4)]
    rows["myers_batch_planes_cuda"] = planes_row(MC, M, sets)
    rows["myers_batch_planes_cuda_thread"] = planes_row(MC, M, sets,
                                                        thread=True)
    for lq in (400, 800, 1024):
        rows["myers_batch_planes_cuda"][f"W{M.n_words(lq)}"] = planes_row(
            MC, M, [to_dev(*planted_pairs(rng, 4096, lq, lq + 72))
                    for _ in range(4)], plain=False)
    rows["myers_batch_planes_cuda_wide"] = planes_row(MC, M, [
        to_dev(*planted_pairs(rng, 1024, 3100, 3172)) for _ in range(2)])
    rows["myers_votes_cuda"], split = votes_times(rng, MC, PU, CR)
    # copy arbitration's chunk batches: Lq 400 (W 13, 2 pairs a warp), Lt
    # 472, planted pairs at ~10% edits, unweighted (chunks carry no quality)
    arb = [votes_inputs(rng, 4096, 400, 64) for _ in range(2)]
    rows["myers_votes_cuda"]["arbitration_shape"], _, _ = votes_row(
        MC, PU, [to_dev(*ops)[:7] for ops, _, _ in arb], arb[0][1],
        arb[0][2], judged_cfg().min_identity)
    rows["myers_batch_cuda_shared"] = shared_row(rng, MC, M, genome_len)
    rows["myers_batch_cuda_carry"] = carry_row(rng, MC, M, genome_len)
    # the device scratch where the shape takes it: correction batches of
    # 800-base short reads (W 26); votes_homes times both homes
    wide = [votes_inputs(rng, 4096, 800, 64) for _ in range(2)]
    sets = [to_dev(*ops)[:7] for ops, _, _ in wide]
    rows["myers_votes_cuda_scratch"], _, _ = votes_row(
        MC, PU, sets, wide[0][1], wide[0][2], judged_cfg().min_identity)
    rows["myers_votes_cuda"]["homes"] = votes_homes(rng, MC, PU)
    rows["myers_batch_cuda_wide"], rows["myers_votes_cuda_wide"] = \
        wide_rows(rng, MC, M, PU)
    for name, r in rows.items():
        log(f"  {name}: {json.dumps(r)}")
    log(f"  correction batch (N 4096, Lq 112, Lt 184): {json.dumps(split)}")
    return rows, split


def planes_row(MC, M, sets, thread: bool = False, plain: bool = True):
    """K2s at one shape (or the forced K2 with `thread`, whose "ms" then
    times its operand prep and launch, the work its wrapper did): wrapper
    and kernel alone, bound (bytes: the planes), registers, blocks, the
    plain version's time unless not `plain`; K2s beside K2's kernel alone
    on the same inputs where K2 takes the W."""
    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    W = M.n_words(Lq)
    kernel_sets = [MC.planes_operands(*a, thread=thread) for a in sets]
    r = kernel_sets[0][0]
    wrapper = MC.myers_batch_planes_cuda if not thread else \
        (lambda *a: MC.run_planes_kernel(*MC.planes_operands(*a,
                                                              thread=True)))
    row = time_row(dict(N=N, Lq=Lq, Lt=Lt, W=W, G=r.G, wl=r.wl,
                        ring=r.ring, forced=thread), wrapper, sets,
                   MC.run_planes_kernel, kernel_sets,
                   M.myers_batch_planes if plain else None,
                   *myers_cost(N, Lq, Lt, True))
    del kernel_sets
    row.update(zip(("registers", "local_bytes"),
                   MC.kernel_attrs(W, planes=True, thread=thread)),
               blocks=-(-N // (MC.THREADS // r.G)), smem=r.smem)
    if not thread and W <= MC.THREAD_MAX_WORDS:
        row["thread_kernel_ms"] = B.cuda_ms(
            MC.run_planes_kernel,
            [MC.planes_operands(*a, thread=True) for a in sets[:2]], 20,
            passes=3)
    return row


def votes_homes(rng, MC, PU):
    """K2''s two plane homes, kernel alone, on the same planted correction
    batches (N 4096, band 64: Lt = Lq + 72) at copy arbitration's shape
    (Lq 400, W 13) and at W 11, 17, 20, 22, 24 and 26: shared memory (where a
    block fits) with the blocks an SM it holds, and the device scratch;
    votes_route's cutoff comes from these rows."""
    import torch

    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.utils import benchmarks as B

    mi = judged_cfg().min_identity
    rows = []
    for lq in (320, 400, 527, 620, 682, 744, 800):
        made = [votes_inputs(rng, 4096, lq, 64) for _ in range(2)]
        nb, lpad = made[0][1], made[0][2]
        size_v = nb * lpad * PU.N_SYM
        merged = torch.zeros(size_v + nb * lpad * 12 + 1, dtype=torch.int32,
                             device="cuda")
        kw = dict(min_identity=mi, size_v=size_v, lpad=lpad, ins_slots=3,
                  max_steps=lq + int((1.0 - mi) * lq) + 2)
        ops = [MC.votes_operands(merged, *to_dev(*m)[:7], scratch=True, **kw)
               for m, _, _ in made]
        r = ops[0][0]
        smem = r._replace(smem=r.smem + r.pairs * r.stride * 4, scratch=False)
        row = dict(W=r.W, Lq=lq, Lt=lq + 72, G=r.G,
                   route="scratch" if MC.votes_route(lq, lq + 72).scratch
                   else "smem", smem_per_block=smem.smem)
        if smem.smem <= MC.SMEM_MAX:
            row["smem_blocks_per_sm"] = MC.votes_attrs(smem)[2]
            row["smem_ms"] = B.cuda_ms(
                MC.run_votes_kernel,
                [(smem, *o[1:3], (None, None, o[1][0].shape[0]), *o[4:])
                 for o in ops], 20, passes=3)
        row["scratch_ms"] = B.cuda_ms(MC.run_votes_kernel, ops, 20, passes=3)
        rows.append(row)
        log(f"  K2' homes: {json.dumps(row)}")
    return rows


def correction_batches(rng, n_sets=4, N=4096, nb=64, L=8192):
    """Real correction batches at the judged shape, as _prep's inputs:
    `nb` random backbones of L bases, 100 bp short reads copied from them
    with 11% edits (5% substitutions, 3% insertions, 3% deletions: a 1%
    short read against a long read of the judged model's 10% error), half
    of them reverse complemented, each read a candidate of its backbone at
    its true diagonal.  Returns one _prep argument tuple (after band, Lq,
    Wt) per set of N pairs, and the backbones' pad."""
    import numpy as np
    import torch

    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.ops.kmer import words_to_tensor

    acgt = np.array(list("ACGT"))
    back = rng.integers(0, 4, (nb, L))
    pr_b = pack_reads(["".join(acgt[r]) for r in back],
                      names=[f"b{i}" for i in range(nb)], category=[1] * nb,
                      pad_len=L)
    n = N * n_sets
    bi = rng.integers(0, nb, n)
    p = rng.integers(0, L - 100, n)
    strand = rng.integers(0, 2, n)
    src = back[bi[:, None], p[:, None] + np.arange(100)[None, :]]
    op = rng.random(src.shape)
    codes = np.empty_like(src)
    for r in range(n):              # 5% sub, 3% insertion, 3% deletion
        out = []
        for c, u in zip(src[r], op[r]):
            if u < 0.03:
                continue
            out.append((c + 1 + int(u * 100) % 3) % 4 if u < 0.08 else c)
            if u > 0.97:
                out.append(int(u * 1e4) % 4)
        out = (out + list(rng.integers(0, 4, 100)))[:100]
        codes[r] = out if strand[r] == 0 else [3 - c for c in out[::-1]]
    pr_s = pack_reads(["".join(acgt[r]) for r in codes],
                      names=[f"r{i}" for i in range(n)], pad_len=112)
    dev = torch.device("cuda")
    i32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)
    i64 = lambda x: torch.from_numpy(x.astype(np.int64)).to(dev)
    r_dev, b_dev = (words_to_tensor(x.packed, dev) for x in (pr_s, pr_b))
    rlen, blen = i32(pr_s.length), i32(pr_b.length)
    # _prep's window offset: -dd forward, dd + lb - la reverse
    dd = np.where(strand == 1, p - L + 100, -p)
    sets = []
    for k in range(n_sets):
        sl = slice(k * N, (k + 1) * N)
        sets.append((r_dev, rlen, None, b_dev, blen,
                     i64(np.arange(n)[sl]), i64(bi[sl]), i64(strand[sl]),
                     i64(dd[sl]), N))
    return sets, L


def votes_row(MC, PU, sets, nb, lpad, min_identity, plain_sets=None):
    """K2' on batches (q, t, qlen, tlen, bb, off, lb), unweighted: the
    wrapper, the kernel alone and the plain version (its time from its
    call on the first set); the bound counts this run's work — the DP's N
    Lt W words, each gated pair's walk (its qlen diag/up moves and at most
    dist left moves) and one 4-byte atomic per vote cast — read from the
    plain version's results on the first `plain_sets` sets (all by
    default) and from the kernel's past them, which must then equal the
    plain version's (dist, tend, votes) on the first set; and the route's
    registers, shared memory a block and blocks resident an SM."""
    import torch

    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * 3 * 4
    kw = dict(min_identity=min_identity, size_v=size_v, lpad=lpad,
              ins_slots=3, max_steps=Lq + int((1.0 - min_identity) * Lq) + 2)
    held = len(sets) if plain_sets is None else plain_sets
    steps = votes = gated = 0
    plain_ms = None
    before = launch_counts()
    for i, a in enumerate(sets):      # the work of this run's data
        m = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
        if i < held:
            t0 = time.perf_counter()
            res, _ = PU.myers_votes(m, *a, **kw)
            torch.cuda.synchronize()
            if i == 0:
                plain_ms = 1e3 * (time.perf_counter() - t0)
        else:
            res, _ = MC.myers_votes_cuda(m, *a, **kw)
        if i == 0 and held < len(sets):
            # the kernel's counts stand for the plain version's past set 0
            mk = torch.zeros_like(m)
            rk, _ = MC.myers_votes_cuda(mk, *a, **kw)
            for what, x, y in (("dist", rk.dist, res.dist),
                               ("tend", rk.tend, res.tend),
                               ("votes", mk[:size_all], m[:size_all])):
                if not torch.equal(x, y):
                    fail(f"K2' W {MC.n_words(Lq)} timing set: the kernel's "
                         f"{what} differ from the plain version's")
        ql = a[2]
        ok = (res.dist <= PU.gate_max_ed(ql, min_identity)) & (ql > 0) \
            & (res.tend > 0)
        gated += int(ok.sum()) / len(sets)
        steps += int((ql.long() + res.dist)[ok].sum()) / len(sets)
        votes += int(m[:size_all].sum()) / len(sets)
    restore(before)
    cells, ops, nbytes = myers_cost(N, Lq, Lt, False)
    ops += steps * B.OPS_PER_WALK_STEP
    nbytes += 4 * 3 * N + 4 * votes
    merged = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
    r = MC.votes_route(Lq, Lt)
    row = time_row(
        dict(N=N, Lq=Lq, Lt=Lt, W=r.W, G=r.G, min_identity=min_identity,
             gated=gated, walk_steps=steps, votes=votes,
             route=("wide, " if r.wl else "") + (
                 "scratch" if r.scratch else "smem"),
             launch_pairs=MC.votes_launch_pairs(r, N)),
        lambda *a: MC.myers_votes_cuda(merged, *a, **kw), sets,
        MC.run_votes_kernel, [MC.votes_operands(merged, *a, **kw)
                              for a in sets],
        None, cells, ops, nbytes, plain_ms=plain_ms)
    regs, local, blocks = MC.votes_attrs(r)
    row.update(registers=regs, local_bytes=local, smem_per_block=r.smem,
               blocks_per_sm=blocks, pairs_per_block=r.pairs,
               blocks=-(-N // r.pairs))
    return row, kw, merged


def votes_times(rng, MC, PU, CR):
    """K2' on real correction batches (the judged shape, _prep's output)
    with both plane homes, and one batch's split: _prep against K2''s
    wrapper (CUDA events), and the batch on the host clock."""
    import torch

    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.utils import benchmarks as B

    band, Lq = 64, 112
    Wt = Lq + band + 8
    prep_sets, lpad = correction_batches(rng)
    nb = 64
    sets = [CR._prep(band, Lq, Wt, *p)[:7] for p in prep_sets]
    cfg = judged_cfg()
    row, kw, merged = votes_row(MC, PU, sets, nb, lpad, cfg.min_identity)
    rs = MC.votes_route(Lq, Wt, scratch=True)
    ms = B.cuda_ms(MC.run_votes_kernel,
                   [MC.votes_operands(merged, *a, scratch=True, **kw)
                    for a in sets], 20, passes=3)
    regs, local, blocks = MC.votes_attrs(rs)
    row["scratch_route"] = dict(
        kernel_ms=ms, pct_of_bound=100 * row["bound_ms"] / ms,
        registers=regs, local_bytes=local, smem_per_block=rs.smem,
        blocks_per_sm=blocks)
    n_before = launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    prep_ms = votes_ms = host_ms = 0.0
    reps = 8
    for r in range(reps + 1):            # the first pass warms up
        t0 = time.perf_counter()
        ev[0].record()
        args = CR._prep(band, Lq, Wt, *prep_sets[r % len(prep_sets)])
        ev[1].record()
        CR._votes_into(merged, cfg, kw["size_v"], lpad, *args)
        ev[2].record()
        torch.cuda.synchronize()
        if r:
            host_ms += 1e3 * (time.perf_counter() - t0) / reps
            prep_ms += ev[0].elapsed_time(ev[1]) / reps
            votes_ms += ev[1].elapsed_time(ev[2]) / reps
    restore(n_before)
    split = dict(prep_ms=round(prep_ms, 4), votes_ms=round(votes_ms, 4),
                 batch_ms=round(prep_ms + votes_ms, 4),
                 prep_share=round(prep_ms / (prep_ms + votes_ms), 4),
                 host_batch_ms=round(host_ms, 4))
    return row, split


def refine_sets(rng, A, N, Lq, band, n_sets=4):
    """The refine's operands at one short-read width: forward (Lt = Lq +
    band + 8, planted, ragged) and the reverse pass made from the forward
    results (reversed prefixes, twice the band)."""
    Lt = Lq + band + 8
    fwd = [planted_pairs(rng, N, Lq, Lt, lead=band // 2)
           for _ in range(n_sets)]
    rev = []
    for q, t, ql, tl in fwd:
        r = A.banded_sw_batch(*to_dev(q, t, ql, tl), band=band)
        rev.append(reversed_prefixes(q, t, r.qend.cpu().numpy(),
                                     r.tend.cpu().numpy()))
    return (("forward", fwd, band), ("reverse", rev, 2 * band)), Lt


def sw_cells_fast(A, qlen, tlen, band) -> int:
    """A.sw_cells over the distinct (qlen, tlen) pairs, each weighted by
    its count (one row each: the long-query sets would build (N, Lq)
    arrays)."""
    import numpy as np

    pairs, counts = np.unique(np.stack([qlen, tlen], axis=1), axis=0,
                              return_counts=True)
    return sum(int(c) * A.sw_cells(p[:1], p[1:], band)
               for p, c in zip(pairs, counts))


def swept_slot_steps(r, sets, Lq, Lt, band):
    """Slot-steps a K3', K3'' or K3''' launch sweeps, a set on average: 32 K
    (32 K nw; K3''' in memory band + 1) per anti-diagonal up to each pair's
    last in-band one (K3' from d = 2, K3'' and K3''' with register slots in
    pairs of steps from d = 2 - (band & 1), K3''' in memory from d = 2)."""
    import numpy as np

    band = min(band, max(Lq, Lt))
    ql = np.clip(np.concatenate([x[2] for x in sets]), 0, Lq).astype(
        np.int64)
    tl = np.minimum(np.concatenate([x[3] for x in sets]), Lt)
    dend = np.where(ql >= 1, ql + np.minimum(tl, ql + band), 1)
    if r.kind == "diag" or (r.kind == "wide" and r.K == 0):
        steps = (dend - 1).clip(min=0)
    else:
        d0 = 2 - (band & 1)
        steps = np.where(dend >= d0, 2 * ((dend - d0) // 2 + 1), 0)
    slots = band + 1 if r.K == 0 else 32 * r.K * r.nw
    return slots * steps.sum() / len(sets)


def sw_row(AC, A, sets, band, kind=None, beside=None, plain_ms=None):
    """One SW timing row: the wrapper and the kernel alone of the route the
    shape takes, GCUPS on in-band cells, the bound, registers and the warps
    an SM holds; for K3', K3'' and K3''' the share of the swept slot-steps
    in band; beside it the kernels of other routes on the same inputs
    (`beside`, by default K3'' and K3 beside K3', K3''' and K3 beside
    K3'', K3 beside K3''').  With `kind` ("rows" or "wide"), the row is
    that route's, forced: "ms" then times its operand prep and launch, the
    work the wrapper would do there.  `plain_ms`: the plain version's time
    where the caller measured it (at a cut)."""
    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    dev_sets = [x if hasattr(x[0], "is_cuda") else to_dev(*x) for x in sets]
    # the lengths on the host, for the cell and slot-step counts
    sets = [(None, None, x[2].cpu().numpy(), x[3].cpu().numpy())
            for x in dev_sets]
    cells = sum(sw_cells_fast(A, x[2], x[3], band) for x in sets) / len(sets)
    kernel_sets = [AC.kernel_operands(*x, band=band, kind=kind)
                   for x in dev_sets]
    r = kernel_sets[0][0]
    if kind is None:
        wrapper = lambda *x: AC.banded_sw_batch_cuda(*x, band=band)
    else:
        wrapper = lambda *x: AC.run_kernel(
            *AC.kernel_operands(*x, band=band, kind=kind))
    row = time_row(
        dict(N=N, Lq=Lq, Lt=Lt, band=band, route=r.kind,
             forced=kind is not None),
        wrapper, dev_sets, AC.run_kernel, kernel_sets,
        lambda *x: A.banded_sw_batch(*x, band=band), cells,
        cells * B.SW_OPS_PER_CELL, 4 * N * (Lq + Lt) + 8 * N + 12 * N,
        plain_ms=plain_ms)
    row.update(zip(("registers", "local_bytes"), AC.kernel_attrs(r)),
               K=r.K, warps=r.warps, nw=r.nw, smem=r.smem,
               warps_per_sm=AC.warps_per_sm(r))
    row["blocks"] = -(-N // (r.warps // r.nw)) if r.kind != "rows" else \
        -(-N // AC.THREADS)
    if r.kind != "rows":
        row["in_band_share"] = cells / swept_slot_steps(r, sets, Lq, Lt,
                                                        band)
        if beside is None:
            beside = {"diag": ("band", "rows"), "band": ("wide", "rows"),
                      "wide": ("rows",)}[r.kind]
        for other in beside:
            # kernel alone of another route on the same inputs
            row[f"{other}_kernel_ms"] = B.cuda_ms(
                AC.run_kernel, [AC.kernel_operands(*x, band=band, kind=other)
                                for x in dev_sets], 20, passes=3)
    return row


def long_sw_sets(seed, N, Lq, band, n_sets=2):
    """Long-query SW operands in bulk, made on the card: random codes, each
    query planted at band // 2 in its target with 5% substitutions, full
    lengths, Lt = Lq + band + 8 (the refine's window)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    Lt = Lq + band + 8
    out = []
    for _ in range(n_sets):
        rnd = lambda hi, n: torch.randint(0, hi, (N, n), generator=g,
                                          device="cuda", dtype=torch.int32)
        q, t = rnd(4, Lq), rnd(4, Lt)
        t[:, band // 2:band // 2 + Lq] = torch.where(rnd(20, Lq) == 0,
                                                     (q + 1) % 4, q)
        out.append((q, t, torch.full((N,), Lq, dtype=torch.int32,
                                     device="cuda"),
                    torch.full((N,), Lt, dtype=torch.int32, device="cuda")))
    return out


def phase_times_k3(rng, AC, A):
    """K3' at the 100 bp refine's shapes (Lq 112: forward band 64, reverse
    band 128) beside the K3'' and K3 kernels on the same inputs; K3'' at
    the 300 bp refine's shapes (Lq 320) beside the K3''' and K3 kernels;
    K3's row, forced at Lq 320 (no shape takes the row route); K3''' at
    the 300 bp refine with --band 128 (the reverse pass at band 256 on
    K3''', its forward pass at 128 on K3''), at band 960 (Lq 320, Lt 1288)
    and at Lq 31,000 (bands 64 and 128, N 4096, its plain version timed at
    a cut, N 8 and Lq LONG_SW_CUT), with no K3 beside them (K3 at band 960
    took 65.98 ms on an H100, PERF.md; at Lq 31,000 it would take seconds
    a launch), and forced onto the 300 bp refine's reverse shape at
    band 128, beside K3'''s row there."""
    log("phase 6: K3', K3'', K3''' and K3 times (CUDA events, distinct "
        "inputs, warm)")
    rows = {}
    for key, Lq in (("banded_sw_batch_cuda", 112),
                    ("banded_sw_batch_cuda_band", 320)):
        passes, Lt = refine_sets(rng, A, 4096, Lq, 64)
        r = {shape: sw_row(AC, A, sets, b) for shape, sets, b in passes}
        rows[key] = dict(r["forward"], reverse=r["reverse"])
    r = {shape: sw_row(AC, A, sets, b, kind="rows")
         for shape, sets, b in passes}
    rows["banded_sw_batch_cuda_rows"] = dict(r["forward"],
                                             reverse=r["reverse"])
    rows["banded_sw_batch_cuda_band"]["reverse"]["wide_forced"] = sw_row(
        AC, A, passes[1][1], passes[1][2], kind="wide", beside=())
    b128, _ = refine_sets(rng, A, 4096, 320, P8_BAND)
    r = {shape: sw_row(AC, A, sets, b) for shape, sets, b in b128}
    wide = dict(r["reverse"], forward_band128=r["forward"])
    wide["band960"] = sw_row(AC, A, [planted_pairs(rng, 4096, 320, 1288,
                                                   lead=480)
                                     for _ in range(4)], 960, beside=())
    for b in LONG_SW_BANDS:
        cut = to_dev(*long_sw_case(b, LONG_SW_CUT))
        wide[f"Lq{LONG_SW_LQ}_band{b}"] = sw_row(
            AC, A, long_sw_sets(b, 4096, LONG_SW_LQ, b), b, beside=(),
            plain_ms=one_call_ms(lambda *a: A.banded_sw_batch(*a, band=b),
                                 cut))
        wide[f"Lq{LONG_SW_LQ}_band{b}"]["plain_cut"] = dict(
            N=LONG_SW_PAIRS, Lq=LONG_SW_CUT)
    rows["banded_sw_batch_cuda_wide"] = wide
    for key, row in rows.items():
        log(f"  {key}: {json.dumps(row)}")
    return rows


def x1_case(rng, N, W, Lt):
    """X1's check pairs at W words: planted, qlen 0, 1, 31 and Lq with code
    4 past qlen, ragged tlen, codes -1/4/9 in the targets; the last word
    not full (Lq = 31 W - 3 past W 1)."""
    import numpy as np

    Lq = 31 * W - (3 if W > 1 else 0)
    q, t, _, _ = planted_pairs(rng, N, Lq, Lt)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:4] = [0, 1, min(31, Lq), Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    t[:64, :8] = rng.choice([-1, 4, 9], size=(min(N, 64), 8))
    return Lq, to_dev(q, t, ql, tl)


# X1's checks, W: (N, Lt), each with partial blocks of 16 S pairs and
# partial slabs: one word a lane to W 32, two at W 34, four at W 100, the
# device scratch at W 300; each at the two (S, BLK) of X1_SB
X1_CHECKS = {1: (1000, 190), 5: (1000, 190), 13: (1000, 190),
             25: (1000, 190), 34: (1000, 190), 100: (300, 190),
             300: (40, 70)}
X1_SB = ((8, 32), (2, 7))
# X2's checks past the old caps, (N, Lq, Lt, band): Lq 1,000 at band 64,
# Lq 320 at band 300 (301 slots); the variants reach every route there
X2_WIDE = ((512, 1000, 1072, 64), (512, 320, 392, 300))
X2_VARIANTS = ("v1", "v2", "v3", "v3g2")
X2_WIDE_VARIANTS = X2_VARIANTS + ("v3g8", "v3g64")


def x_checks(rng, VM, MM, SV, M, A):
    """Phase 9's comparisons: X3, X1 and X2 against their plain versions on
    the card, bit-exact.  Returns {kernel: max |kernel - plain|} (0)."""
    import numpy as np
    import torch

    err = {}
    # X3 at the sweep's C and STEPS, with elements at and near INT32_MAX
    # (the chains wrap there) and at INT32_MIN
    x = np.random.default_rng(3).integers(0, 100, (128, 128)).astype(np.int32)
    x[0, :4] = [2**31 - 5, 2**31 - 1, -2**31, -1]
    xd = torch.from_numpy(x).cuda()
    err["vpu_chains_cuda"] = max(
        eq(f"X3 C={C} STEPS=2048 (3 copies)",
           VM.vpu_chains_cuda(xd, C, 2048, reps=3),
           VM.chains(xd, C, 2048).expand(3, *x.shape))
        for C in (1, 2, 4, 8))
    # X1 at the harness's main() shapes, then at each W of X1_CHECKS
    errs = []
    for N, Lq, Lt, BLK, S in MM.SHAPES[:2]:
        ops, (q, t, ql, tl) = MM.prep(N, Lq, Lt, "cuda")
        got, ref = MM.run_b(*ops, S=S, BLK=BLK), M.myers_batch(q, t, ql, tl)
        errs += [eq(f"X1 N {N} Lq {Lq} Lt {Lt} {f}", getattr(got, f),
                    getattr(ref, f)) for f in ("dist", "tend")]
    for W, (N, Lt) in X1_CHECKS.items():
        Lq, (qd, td, qld, tld) = x1_case(rng, N, W, Lt)
        planes = M.query_planes(qd, qld, W)
        ref = M.myers_batch(qd, td, qld, tld)
        for S, BLK in X1_SB:
            got = MM.run_b(qld, tld, *planes, td, S=S, BLK=BLK)
            g = MM.slab_geometry(N, W, S, BLK)
            where = "scratch" if g.words else "registers"
            errs += [eq(f"X1 W {W} (N {N}, Lq {Lq}, Lt {Lt}; {g.lanes} lanes "
                        f"a pair, {g.pairs} pairs a warp, words in {where}) "
                        f"S {S} BLK {BLK} {f}", getattr(got, f),
                        getattr(ref, f)) for f in ("dist", "tend")]
    err["run_b_cuda"] = max(errs)
    # X2 at check()'s shape, K3's refine shapes (forward band 64, reverse
    # band 128 ragged, homopolymer and ACAC tie rows) and band >= Lq (the
    # query layout), then past the old caps (X2_WIDE; v3, v3g2 at band 300
    # and v3g8, v3g64 take the slots in memory)
    cases = [("check() shape (N 256, Lq 128, Lt 256) band 64",
              *SV.planted_inputs(256, 128, 256), 64, X2_VARIANTS),
             *(c + (X2_VARIANTS,)
               for c in refine_cases(rng, A, 4096, 112, 64)),
             ("band >= Lq (N 512, Lq 40, Lt 60) band 200",
              *sw_edges(rng, 512, 40, 60, 200), 200, X2_VARIANTS),
             *((f"past the old caps (N {N}, Lq {Lq}, Lt {Lt}) band {b}",
                *sw_edges(rng, N, Lq, Lt, b), b, X2_WIDE_VARIANTS)
               for N, Lq, Lt, b in X2_WIDE)]
    errs = {v: [] for v in ("v1", "v2", "v3")}
    for label, q, t, ql, tl, band, variants in cases:
        args = to_dev(q, t, ql, tl)
        ref = A.banded_sw_batch(*args, band=band)
        for v in variants:
            p = SV.plan(v, len(q), q.shape[1], t.shape[1], band)
            got = SV.sw_pallas_exp(*args, band=band, variant=v)
            errs[v[:2]] += [eq(f"X2 {v} ({p.route} K {p.K}, {p.swept} slots "
                               f"a pair) {label} {f}", getattr(got, f),
                               getattr(ref, f)) for f in SW_FIELDS]
    for v, e in errs.items():
        err[f"sw_variants_{v}"] = max(e)
    return err


def sass_dpx(cuda_build):
    """{X2 instantiation: counts of its DPX (integer max, add-max), permute,
    logic, add, compare, select, shared-load and shuffle instructions, and
    of all its instructions}: how long each route's code is and what it is
    made of."""
    import re

    kept = ("VIADDMNMX", "VIMNMX", "VIMNMX3", "IMNMX", "VIADD", "VHMNMX",
            "PRMT", "LOP3", "IADD3", "ISETP", "SEL", "LDS", "SHFL")
    out = {}
    for fn, ops in cuda_build.sass_opcodes("sw_variants").items():
        key = None
        m = re.search(r"swv_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            key = f"i32 K{m.group(1)} flags{m.group(2)}"
        m = re.search(r"swv_packed_kernelILi(\d+)E", fn)
        if m:
            key = f"v2 H{m.group(1)}"
        if "swv_mem_kernel" in fn:
            key = "memory"
        if key:
            out[key] = {op: n for op, n in sorted(ops.items()) if op in kept}
            out[key]["all"] = sum(ops.values())
    return out


def bench_path(cli):
    """`hga-torch bench --what sw|myers|count|pipeline --pairs 8192`
    through cli.main, as a user runs it; each prints one JSON line."""
    out = {}
    for what in ("sw", "myers", "count", "pipeline"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--what", what, "--pairs", "8192"])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"  bench {what} ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(res)}")
        need = ("gcups",) if what in ("sw", "myers") else ("reads_per_s",)
        if rc != 0 or any(k not in res for k in need):
            fail(f"bench --what {what}: rc {rc}, lacks one of {need}")
        out[what] = res
    if out["sw"]["impl"] != "cuda_k3" or out["myers"]["impl"] != "cuda_k1":
        fail("bench sw/myers did not run K3/K1")
    return out


# X1's other timing shapes beside K1' on the same pairs, (N, Lq, Lt, BLK,
# S): the harness's W 1 and bench shapes, W 5 at S 1 and 2 (8x and 4x the
# blocks of S 8), and W 13, 34 and 100 past the old cap at S 2 (32 pairs a
# block: one group a warp; at S 8 these W run 2-4 groups a warp in turn),
# W 34 also at S 8
X1_TIMES = ((4096, 31, 192, 32, 8), (8192, 128, 192, 32, 8),
            (4096, 128, 192, 32, 1), (4096, 128, 192, 32, 2),
            (4096, 400, 192, 32, 2), (4096, 1054, 192, 32, 2),
            (4096, 1054, 192, 32, 8), (4096, 3100, 192, 32, 2))
# X2's timing shapes past the old caps beside K3's route on the same pairs,
# (N, Lq, Lt, band): Lq 1,000 at band 64, Lq 320 at band 300
X2_TIMES = ((4096, 1000, 1072, 64), (4096, 320, 392, 300))


def x_more_rows(MM, SV, M, A, MC, AC):
    """X1 and X2 at X1_TIMES and X2_TIMES: kernel and wrapper ms (CUDA
    events, 20 launches on 2 input sets, warm), bound and share, registers,
    the layout, and K1' or K3's route's kernel on the same inputs.  Their
    launches are no path's: the counters are restored."""
    import numpy as np
    import torch

    from hga_tpu_torch.utils import benchmarks as B

    before = launch_counts()
    x1 = []
    for N, Lq, Lt, BLK, S in X1_TIMES:
        ops, (q, t, ql, tl) = MM.prep(N, Lq, Lt, "cuda")
        sets = MM.target_sets(ops, 2)
        W = M.n_words(Lq)
        g = MM.slab_geometry(N, W, S, BLK)
        kern = B.cuda_ms(lambda *k: MM.run_kernel(*k, S=S, BLK=BLK),
                         [MM.kernel_operands(*a, S=S, BLK=BLK)
                          for a in sets], 20)
        ms = B.cuda_ms(lambda *a: MM.run_b(*a, S=S, BLK=BLK), sets, 20)
        k1 = B.cuda_ms(MC.run_kernel, [MC.kernel_operands(q, s[-1], ql, tl)
                                       for s in sets], 20)
        bound, by = B.bound_ms(N * Lt * W * B.OPS_PER_WORD_COLUMN,
                               16 * N * W + 4 * N * Lt + 16 * N)
        x1.append(dict(
            N=N, Lq=Lq, Lt=Lt, W=W, S=S, BLK=BLK, lanes=g.lanes,
            pairs_a_warp=g.pairs, warps=g.warps, blocks=g.blocks,
            kernel_ms=kern, ms=ms, bound_ms=bound, bound_by=by,
            pct_of_bound=100 * bound / kern, k1_kernel_ms=k1,
            **dict(zip(("registers", "local_bytes"), MM.kernel_attrs(W)))))
        log(f"  X1 {json.dumps(x1[-1])}")
    x2 = []
    for N, Lq, Lt, band in X2_TIMES:
        g = np.random.default_rng(0)
        q = g.integers(0, 4, (N, Lq)).astype(np.int32)
        t = g.integers(0, 4, (N, Lt)).astype(np.int32)
        ql, tl = np.full(N, Lq, np.int32), np.full(N, Lt, np.int32)
        sets = [to_dev((q + i) % 4, t, ql, tl) for i in range(2)]
        cells = A.sw_cells([Lq], [Lt], band) * N
        bound, by = B.bound_ms(cells * B.SW_OPS_PER_CELL,
                               4 * N * (Lq + Lt) + 8 * N + 12 * N)
        k3 = B.cuda_ms(AC.run_kernel, [AC.kernel_operands(*a, band=band)
                                       for a in sets], 20)
        for v in ("v1", "v2", "v3"):
            p = SV.plan(v, N, Lq, Lt, band)
            outs = [tuple(torch.empty(N, dtype=torch.int32, device="cuda")
                          for _ in range(3)) for _ in sets]
            kern = B.cuda_ms(
                lambda *a: SV.run_kernel(*a, variant=v, band=band),
                [(*a, o) for a, o in zip(sets, outs)], 20)
            ms = B.cuda_ms(
                lambda *a: SV.sw_pallas_exp(*a, band=band, variant=v), sets,
                20)
            swept = SV.swept_slot_steps(v, sets[0][2], sets[0][3], Lq, Lt,
                                        band)
            x2.append(dict(
                variant=v, N=N, Lq=Lq, Lt=Lt, band=band, layout=p.route,
                K=p.K, slots=p.S, swept_a_pair=p.swept, query=p.query,
                swept=swept, in_band=cells / swept, kernel_ms=kern, ms=ms,
                bound_ms=bound, bound_by=by, pct_of_bound=100 * bound / kern,
                k3_route=AC.route(Lq, Lt, band).kind, k3_kernel_ms=k3,
                **dict(zip(("registers", "local_bytes"),
                           SV.kernel_attrs(v, Lq, Lt, band)))))
            log(f"  X2 {json.dumps(x2[-1])}")
    restore(before)
    return x1, x2


def x_times(x3_rows, x1_rows, sv_rows, VM, MM, SV, M, A, MC, AC):
    """The X rows of the kernels line: each kernel beside its plain version
    and its bound at the harness's timing shape, and beside K1 or K3 at the
    same shape (from the harnesses' own rows); then X1 and X2 at the other
    shapes of X1_TIMES and X2_TIMES."""
    import numpy as np
    import torch

    from hga_tpu_torch.utils import benchmarks as B

    rows = {}
    # X1 at the harness's first shape (N 4096, Lq 128, Lt 192, W 5)
    N, Lq, Lt, BLK, S = MM.SHAPES[0]
    W = M.n_words(Lq)
    ops, _ = MM.prep(N, Lq, Lt, "cuda")
    sets = MM.target_sets(ops)
    rows["run_b_cuda"] = time_row(
        dict(N=N, Lq=Lq, Lt=Lt, W=W, BLK=BLK, S=S),
        lambda *a: MM.run_b(*a, S=S, BLK=BLK), sets,
        lambda *k: MM.run_kernel(*k, S=S, BLK=BLK),
        [MM.kernel_operands(*a, S=S, BLK=BLK) for a in sets],
        lambda ql, tl, q0, q1, vq, mend, t: M.myers_batch_from_planes(
            q0, q1, vq, mend, t, ql, tl),
        N * Lq * Lt, N * Lt * W * B.OPS_PER_WORD_COLUMN,
        16 * N * W + 4 * N * Lt + 8 * N + 8 * N)
    rows["run_b_cuda"].update(zip(("registers", "local_bytes"),
                                  MM.kernel_attrs(W)))
    g = MM.slab_geometry(N, W, S, BLK)
    rows["run_b_cuda"].update(lanes=g.lanes, pairs_a_warp=g.pairs,
                              warps=g.warps, blocks=g.blocks)
    beside = next(r for r in x1_rows if (r["N"], r["Lq"]) == (N, Lq))
    rows["run_b_cuda"]["beside_k1"] = {
        k: beside[k] for k in ("k1_ms", "k1_kernel_ms", "kernel_ms")}
    # X2 at timeit()'s shape (N 4096, Lq 128, Lt 256, band 64)
    N, Lq, Lt, band = 4096, 128, 256, 64
    g = np.random.default_rng(0)
    q = g.integers(0, 4, (N, Lq)).astype(np.int32)
    t = g.integers(0, 4, (N, Lt)).astype(np.int32)
    ql, tl = np.full(N, Lq, np.int32), np.full(N, Lt, np.int32)
    sets = [to_dev((q + i) % 4, t, ql, tl) for i in range(4)]
    cells = A.sw_cells([Lq], [Lt], band) * N
    for v in ("v1", "v2", "v3"):
        outs = [tuple(torch.empty(N, dtype=torch.int32, device="cuda")
                      for _ in range(3)) for _ in sets]
        rows[f"sw_variants_{v}"] = time_row(
            dict(N=N, Lq=Lq, Lt=Lt, band=band, variant=v),
            lambda *a: SV.sw_pallas_exp(*a, band=band, variant=v), sets,
            lambda *a: SV.run_kernel(*a, variant=v, band=band),
            [(*a, o) for a, o in zip(sets, outs)],
            lambda *a: A.banded_sw_batch(*a, band=band), cells,
            cells * B.SW_OPS_PER_CELL, 4 * N * (Lq + Lt) + 8 * N + 12 * N)
        rows[f"sw_variants_{v}"].update(zip(("registers", "local_bytes"),
                                            SV.kernel_attrs(v, Lq, Lt, band)))
        p = SV.plan(v, N, Lq, Lt, band)
        beside = next(r for r in sv_rows if r["variant"] == v)
        rows[f"sw_variants_{v}"].update(
            layout=p.route, K=p.K, swept_a_pair=p.swept, swept=beside["swept"],
            in_band=beside["in_band"], beside_k3={
                k: beside[k] for k in ("k3_ms", "k3_kernel_ms", "kernel_ms")})
    rows["sw_variants_v1"]["ablations"] = {
        r["variant"]: {k: r[k] for k in ("ms", "kernel_ms", "gcups")}
        for r in sv_rows if "no" in r["variant"]}
    rows["sw_variants_v3"]["v3g2"] = {
        k: r[k] for r in sv_rows if r["variant"] == "v3g2"
        for k in ("ms", "kernel_ms", "gcups", "swept", "in_band")}
    x1, x2 = x_more_rows(MM, SV, M, A, MC, AC)
    rows["run_b_cuda"]["more"] = x1
    for v in ("v1", "v2", "v3"):
        rows[f"sw_variants_{v}"]["more"] = [r for r in x2
                                            if r["variant"] == v]
    # X3 at the sweep's fastest C (R 128, STEPS 2048, default_reps copies)
    best = max((r for r in x3_rows if "C" in r and r["R"] == 128),
               key=lambda r: r["lane_ops_per_s"])
    C, steps, reps = best["C"], best["steps"], best["reps"]
    xs = [(torch.full((128, 128), 7 + i, dtype=torch.int32, device="cuda"),)
          for i in range(4)]
    outs = [torch.empty((reps, 128, 128), dtype=torch.int32, device="cuda")
            for _ in xs]
    elems = 128 * 128 * reps
    # the bound counts the add/max instructions the SASS holds (nvcc fuses
    # a step's add and max into one VIADDMNMX), issued at INT32_OPS_PER_S
    instr = sum(best["sass_add_max"].values())
    rows["vpu_chains_cuda"] = time_row(
        dict(R=128, C=C, steps=steps, reps=reps),
        lambda x: VM.vpu_chains_cuda(x, C, steps, reps), xs,
        lambda x, o: VM.run_kernel(x, C, steps, o),
        [(x, o) for (x,), o in zip(xs, outs)],
        lambda x: VM.chains(x.repeat(reps, 1), C, steps), 0,
        instr * elems, 8 * elems)
    rows["vpu_chains_cuda"].update(
        zip(("registers", "local_bytes"), VM.kernel_attrs(C, steps)),
        lane_ops_per_s=best["lane_ops_per_s"],
        instr_per_s=best.get("instr_per_s"), share=best.get("share"),
        sass_add_max=best.get("sass_add_max"))
    for name, r in rows.items():
        log(f"  {name}: {json.dumps(r)}")
    return rows


def phase_measurement(rng, VM, MM, SV, M, A, MC, AC, cuda_build):
    """Phase 9: the measurement path.  Returns (max errors, launches by
    path, timing rows, bench results)."""
    from hga_tpu_torch import cli

    log("phase 9: the measurement path (harness kernels X1-X3, "
        "hga-torch bench)")
    t9 = t0 = time.perf_counter()
    err = x_checks(rng, VM, MM, SV, M, A)
    log(f"  checks: {time.perf_counter() - t0:.1f} s")
    dpx = sass_dpx(cuda_build)
    log(f"  X2 SASS integer max / add-max instructions: {json.dumps(dpx)}")
    # the harnesses as a user runs them: python -m hga_tpu_torch.exp.<name>
    before = launch_counts()
    t0 = time.perf_counter()
    x3_rows = VM.main([])
    x1_rows = MM.main([])
    sv_rows = SV.main(["--time", "--variants",
                       "v1,v2,v3,v3g2,v1nots,v1nos1,v1nomask,v1nobest"])
    # the harness kernels' launches alone: main() times K1' and K3' beside
    # them, and a timing loop's launches are no path's
    got = launch_counts() - before
    harness = {name: got[name] for name in (
        "vpu_chains_cuda", "run_b_cuda", *SV.COUNTER.values())}
    log(f"  harnesses ({time.perf_counter() - t0:.1f} s), launches: "
        f"{json.dumps(harness)}")
    for name, n in harness.items():
        if n <= 0:
            fail(f"{name} was never launched by the harnesses")
    if not all(r["ok"] for r in x1_rows):
        fail("myers_micro main(): X1 differs from the plain version")
    if not all("share" in r for r in x3_rows if "C" in r):
        fail("vpu_micro main(): no SASS add/max count")
    zero_launches()
    t0 = time.perf_counter()
    bench = bench_path(cli)
    launches = launch_counts()
    log(f"  bench ({time.perf_counter() - t0:.1f} s), launches: "
        f"{json.dumps(launches)}")
    for name in ("myers_batch_cuda", "banded_sw_batch_cuda"):
        if launches[name] <= 0:
            fail(f"{name} was never launched by hga-torch bench")
    rows = x_times(x3_rows, x1_rows, sv_rows, VM, MM, SV, M, A, MC, AC)
    rows["dpx"] = dpx
    log(f"  phase 9: {time.perf_counter() - t9:.1f} s")
    paths = {"phase 9 harnesses": harness, "phase 9 bench": launches}
    return err, paths, rows, bench


def phases_on_card(args, ph, kinds, rng, err, paths, workdir, done, pool,
                   MC, M, PU, AC, A):
    """Phases 2, 3, 7, c (kernel), 4, 8, 10, c and b, in that order; fills
    `err` and `paths`; returns phase 4's run (None where it did not run)
    and phase c's CLI part, submitted to `pool` once phase c's ranks have
    ended (None where c did not run)."""
    import torch

    # the plain version of phase 2's and 7's longest cases, in processes of
    # their own on the card beside phases 2 and 3
    with plain_procs(n for n in LONG_PLAINS
                     if ("2" if n == "gate" else "7") in ph) as plains:
        if "2" in ph:
            err.update(phase_k1(rng, MC, M))
            err["myers_batch_cuda_shared"] = phase_k1_shared(rng, MC, M)
            err["myers_batch_cuda_carry"] = phase_carry_wide(rng, MC, M)
            done("2")
        if "3" in ph:
            err.update(phase_k2(rng, MC, M, PU))
            err.update(phase_k2v(rng, MC, PU))
            done("3")
        if "2" in ph:
            err["myers_batch_cuda_wide"] = max(
                err["myers_batch_cuda_wide"],
                phase_gate_long(MC, M, plains))
            done("2 (its longest gate case)")
        if "7" in ph:
            err.update(phase_k3(rng, AC, A, plains))
            done("7")
    if "c" in ph:
        err["myers_batch_cuda_carry"] = max(
            phase_carry(rng, MC, M), err["myers_batch_cuda_carry"] or 0)
        done("c (kernel)")
    torch.cuda.synchronize()

    # launches per kernel on each path that ran: K1' and K2' on the hybrid
    # pipeline (phases 4 and 10), K1' and K3' on config 3 and K1' and K3'' on
    # its 300 bp drive (phase 8), K1''s shared-target mode on
    # segment_identity (phase 10), X1-X3 on the harnesses and K1'/K3' on
    # hga-torch bench (phase 9), K1'/K2' at W 26 and K1'/K3' on
    # hga_tpu_torch.bench and graft_entry (phase e)
    p4 = None
    if "4" in ph or "c" in ph or "d" in ph:
        paths["phase 4 hybrid pipeline"], p4 = phase_pipeline(
            args.genome_len, MC, workdir)
        done("4")
    if "8" in ph:
        paths["phase 8 config 3"], _ = phase_config3(
            CONFIG3_GENOME, MC, AC)
        paths["phase 8 config 3, 300 bp reads"], _ = phase_config3(
            MISEQ_GENOME, MC, AC, read_len=300, seed=44)
        paths["phase 8 config 3, 300 bp reads, --band 128"], _ = \
            phase_config3(MISEQ_GENOME, MC, AC, read_len=300, seed=44,
                          band=P8_BAND)
        p8_band128_card(workdir, MC, AC)
        done("8")
    if "a" in ph:
        paths.update(phase_genomes(args.phase10_len, kinds, MC, workdir))
        done("10")
    c_cli = None
    if "c" in ph:
        c_paths, cli_args = phase_distributed(args.genome_len, workdir, p4)
        paths.update(c_paths)
        done("c (the ranks)")
        # the CLI runs (processes of their own) beside phases b and d
        c_cli = pool.submit(phase_c_cli, *cli_args)
    if "b" in ph:
        paths.update(phase_b(args.genome_len, workdir, MC, AC))
        done("b")
    return p4, c_cli


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-len", type=int, default=P4_GENOME,
                    help="genome length of phase 4, whose reads and run "
                         f"phases b, c and d reuse (default {P4_GENOME:,} "
                         "bp)")
    ap.add_argument("--phase10-len", type=int, default=PHASE10_GENOME,
                    help=f"genome length of phase 10 (default "
                         f"{PHASE10_GENOME:,} bp)")
    ap.add_argument("--phases", default="0123456789abcdek",
                    help="phases to run, 'a' for phase 10, 'b', 'c', 'd', "
                         "'e' and 'k' for phases b, c, d, e and k (default "
                         "all)")
    ap.add_argument("--phase10", default="repeats+circular",
                    help="phase 10's genomes, comma-separated among "
                         + ", ".join(PHASE10_GENOMES))
    args = ap.parse_args()
    kinds = args.phase10.split(",")
    if not set(kinds) <= set(PHASE10_GENOMES):
        ap.error(f"--phase10 takes {', '.join(PHASE10_GENOMES)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke runs "
              "on a CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hga_tpu_torch", "csrc")):
        print("FAIL: hga_tpu_torch/ is not next to chip_smoke.py",
              file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    from hga_tpu_torch.exp import myers_micro as MM
    from hga_tpu_torch.exp import sw_variants as SV
    from hga_tpu_torch.exp import vpu_micro as VM
    from hga_tpu_torch.ops import align as A
    from hga_tpu_torch.ops import align_cuda as AC
    from hga_tpu_torch.ops import cuda_build
    from hga_tpu_torch.ops import kmer_cuda as KC
    from hga_tpu_torch.ops import myers as M
    from hga_tpu_torch.ops import myers_cuda as MC
    from hga_tpu_torch.ops import pileup as PU
    from hga_tpu_torch.utils.benchmarks import card_line

    ph = set(args.phases)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all(force=True)
    built = {n: dict(cuda_build.BUILD_INFO[n]) for n in libs}
    for mod in (MC, AC, VM, MM, SV, KC):
        mod._lib()
    MC._gate_lib()
    MC._votes_lib()
    log(f"phase 1: built {len(libs)} libraries (one nvcc each, in parallel) "
        f"in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{os.path.relpath(p, HERE)} {built[n]['seconds']:.1f} s"
            for n, p in libs.items()))
    report = ptxas_report("".join(str(b["ptxas"]) for b in built.values()))
    # K1': both designs to 24 words, the split design to 34, the wide
    # route; K2; K2s to 34 words and its wide route; K2': 7 register
    # instances on both homes, the wide route; K3', K3'', K3''' (8 register
    # instances, its slots in memory twice), K3 twice; the harnesses'; the
    # k-mer key kernel
    expect = ((2 * MC.SINGLE_MAX_WORDS - 1)
              + (MC.REGISTER_MAX_WORDS - MC.SINGLE_MAX_WORDS) + 1
              + MC.THREAD_MAX_WORDS + MC.REGISTER_MAX_WORDS + 1 + 2 * 7 + 1
              + len(AC.DIAG_SLOTS) + len(AC.BAND_SLOTS) + AC.WIDE_SLOTS + 2
              + 2 + MM.REGISTER_WORDS + 1 + len(SV.BUILT) + len(VM.BUILT)
              + 3)
    log(f"  ptxas report: {len(report)} of {expect} kernel instantiations "
        "parsed")
    for kern, by in (("K1'", "W, lanes a pair"), ("K2", "W"),
                     ("K2s", "W, lanes a pair (W0: the wide route)"),
                     ("K2'", "lanes a pair, words a lane, plane home"),
                     ("K3'", "slots a lane"), ("K3''", "slots a lane"),
                     ("K3'''", "slots a lane, or slots in memory"),
                     ("K3", "buffer"), ("X1", "words a lane"),
                     ("X2", "route"), ("X3", "C, STEPS"),
                     ("kmer", "slots a thread")):
        rows = [r for r in report if r[0] == kern]
        log(f"  ptxas {kern} registers by {by}: "
            + " ".join(f"{w}:{regs}" for _, w, regs, _ in rows))
        log(f"  ptxas {kern} spill stores/loads (bytes) where nonzero: "
            + (" ".join(f"{w}:{s[0]}/{s[1]}" for _, w, _, s in rows if any(s))
               or "none"))

    def done(phase: str) -> None:
        log(f"  phase {phase} done, {time.perf_counter() - t0:.1f} s since "
            "phase 1 began")

    done("1")
    rng = np.random.default_rng(7)
    err = dict.fromkeys(KERNELS)     # None: the kernel's check did not run
    workdir = tempfile.mkdtemp(prefix="hga_smoke_")
    paths = {}
    kmer_row = {}
    if "k" in ph:
        err["kmer_keys"], k_paths, kmer_row = phase_kmer(
            np.random.default_rng(18))
        paths.update(k_paths)
        done("k")
    # the CPU side of phases 5, 8, b and e, each run in a process of its
    # own at the lowest priority, from here on beside every phase on the
    # card; each phase holds its runs against theirs once they have ended
    twins = (P5_TWINS if "5" in ph else ()) + \
        (P8_TWINS if "8" in ph else ()) + \
        (B_TWINS if "b" in ph else ()) + (E_TWINS if "e" in ph else ())
    try:
        with cpu_twins(twins, workdir) as jobs:
            log(f"  started the CPU side of {len(jobs)} card == CPU runs "
                "(nice 19)")
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                p4, cli = phases_on_card(args, ph, kinds, rng, err, paths,
                                         workdir, done, pool, MC, M, PU, AC,
                                         A)
                if "d" in ph:
                    paths.update(phase_scripts(args.genome_len, workdir, p4,
                                               MC))
                    done("d")
                if cli is not None:
                    for line in cli.result():
                        log(line)
                    done("c (its CLI, beside phases b and d)")
            if "5" in ph:
                phase_cpu_equal(workdir, MC, AC)
            early = [j for j in jobs if j[0] not in E_TWINS]
            twins_equal(early, workdir)
            if "5" in ph:
                done("5")
            if "e" in ph:
                e_jobs = [j for j in jobs if j[0] in E_TWINS]
                twins_wait(e_jobs)
                e_paths, err_e = phase_wide(workdir, MC, AC, A, e_jobs)
                paths.update(e_paths)
                err["banded_sw_batch_cuda"] = max(
                    err["banded_sw_batch_cuda"] or 0, err_e)
                done("e")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # every kernel in the line, each value null where its phase did not run
    entries = {name: dict(
        name=name, route="cuda", source=src, replaces=rep, launches=None,
        launches_by_path={}, max_abs_err=None, matches_plain=None, ms=None,
        kernel_ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None, gcups=None, shape=None, registers=None,
        local_bytes=None) for name, (src, rep) in KERNELS.items()}
    entries["kmer_keys"].update(kmer_row)
    if "6" in ph:
        rows, split = phase_times(rng, MC, M, PU, SEGMENT_GENOME)
        rows.update(phase_times_k3(rng, AC, A))
        for name, r in rows.items():
            entries[name].update(r)
        done("6")
    if "9" in ph:
        x_err, x_paths, x_rows, bench = phase_measurement(
            rng, VM, MM, SV, M, A, MC, AC, cuda_build)
        err.update(x_err)
        paths.update(x_paths)
        for name in KERNELS:
            entries[name].update(x_rows.get(name, {}))
        done("9")
    for name, e in entries.items():
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        e.update(launches=sum(by_path.values()) if paths else None,
                 launches_by_path=by_path, max_abs_err=err[name],
                 matches_plain=None if err[name] is None else err[name] == 0)
    log("  no single PyTorch call computes Myers edit distance (per pair or "
        "against a shared row), its traceback votes, banded local SW or the "
        "add/max chains, nor canonical k-mer keys: library_ms is null")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
