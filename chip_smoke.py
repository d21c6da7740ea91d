#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (hga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, 1 Mb genome
    python3 chip_smoke.py --genome-len 4600000 --phases 014a \
        --phase10 repeats,circular,repeats+circular   # judged quality rows

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. card facts: nvidia-smi name/power limit, torch and CUDA versions
  1. build the CUDA kernels from hga_tpu_torch/csrc (one nvcc per source,
     in parallel, sm_90a), timed; registers/spills per instantiation
  2. K1' (myers_batch_cuda) == its plain PyTorch version, bit-exact, through
     the wrapper and in the other design (G 1 or group_width(W)), at the
     long-overlap shape (N 4096, Lq 414, Lt 478), the config-3 gate shape
     (N 4096, Lq 112, Lt 184, ragged, code-4 padding) and at W 1, 2, 4, 5,
     14, 16, 24 with qlen 0, 1, 31, 32, 62, Lq - 1, ragged tlen and codes
     -1, 4, 9; then K1''s shared-target mode (one target row for every
     pair, counted as myers_batch_cuda_shared) at segment_identity's shape
     (segments of 384, W 13, against genome . sentinel . revcomp of a 10 kb
     genome: Lt 20001) and at W 4 and W 1 with qlen 0, 1, 31, 32 and target
     codes -1, 4, 9
  3. K2 (myers_batch_planes_cuda) == its plain version (dist, tend, Pv, Mv)
     at the correction shape (N 4096, Lq 112, Lt 184), and the traceback
     votes made from each set of planes are equal; then K2'
     (myers_votes_cuda: DP, gate, traceback and votes in one launch) ==
     its plain version (dist, tend and the vote buffer less its sink) at
     the correction shape (min_identity 0.9, weighted and unweighted, qlen
     0, 1, 31, 62 and multiples of 10, target codes -1 and 9, ragged tlen),
     at W 1, 2, 11 (300 bp reads) and 24, at copy arbitration's shape (Lq
     400, W 13, Lt 472), and on the device-scratch route (band 960, by
     shape; and the correction shape on it); each route's counter must move
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
     both designs at W 14, 4, 5 and 1, K2, K3' at the refine's shapes
     beside K3'' and K3's kernels on the same inputs, K3'' at the 300 bp
     refine's shapes (Lq 320, forward band 64 and reverse band 128) with
     its in-band share, K and shared memory, beside K3's kernel on the same
     inputs (K3's row, forced there); K2' on real correction batches
     (_prep's output) on both plane homes, its shared memory and blocks an
     SM; and the correction batch split (_prep / K2')
  7. banded_sw_batch_cuda == its plain version, bit-exact, every case
     through the wrapper, whose route counter must move: K3' at the
     refine's forward (N 4096, Lq 112, Lt 184, band 64) and reverse (band
     128, ragged) shapes (and K3'' forced on both) and at Lq 1, 31, 32, 33,
     112, 128, 129, 256 at bands 0, 64, 128, >= Lq; K3'' at the 300 bp
     refine's forward (N 4096, Lq 320, Lt 392, band 64) and reverse (band
     128, ragged) shapes, at Lq 257, 320, 1024 at bands 0, 1, 64, 127, 128,
     at bands 31, 32, 63, 64, 255 (K's edges) and at Lq 1024 and 1100; K3
     (rows) at band >= Lq above Lq 256 and band 960 (device scratch); tie
     rows, -1 and 4 codes, qlen/tlen 0 everywhere
  8. judged config 3, compute_overlaps_cross(device="cuda") with the SW
     refine, on the phase-4 reads: K1' and K3' counters must move, K3''
     and K3 stay 0, truth precision >= 0.95; then 300 bp reads on a 100
     kb genome, whose refine width takes K3'' (K3' and K3 stay 0)
  9. the measurement path: X1 (exp/myers_micro run_b), X2 (exp/sw_variants
     v1, v2, v3) and X3 (exp/vpu_micro) == their plain versions, bit-exact;
     then the three harnesses' main() as a user runs them (their counters
     must move), the SASS add/max count of X3 and the DPX instructions of
     X2, and `hga-torch bench --what sw|myers|count|pipeline --pairs 8192`
     through cli.main (the K1' and K3' counters must move)
  a. (phase 10) the pipeline on a repeat-bearing genome (sim.repeat_genome)
     with circular reads, through hga_tpu_torch.exp.scale_run as its
     --repeats --circular runs it: contigs, circular contigs, k-mer
     identity judged as a circle (>= 0.99), genome fraction, then
     utils/evalx.segment_identity on the card
     (K1''s shared-target counter must move); --phase10 picks the genomes
     (repeats, circular, repeats+circular)

  c. distribution (parallel/): K1''s carried-state mode
     (myers_cols_cuda, counted as myers_batch_cuda_carry) == ops/myers
     .myers_cols bit-exact at segment_identity's shape (W 13, shared row)
     and the long-overlap shape (W 14, per-pair rows) with qlen 0, 1, 31,
     32, ragged tlen and codes -1, 4, 9, and chained over 2, 3 and 8 chunks
     == one chunk == one-shot K1'; then, after phase 10, two ranks sharing
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
     of phase 4's run directory: bench_corr_tb (K2 and K2' must move; the
     vote buffers of the K2 planes' traceback, fused_full_S and
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

Phase 5 also runs config 3 (100 bp and 300 bp reads) and the
short-read-only pipeline (8 kb genome) on cuda and on cpu, byte-identical.
Phases run in the order 0 1 2 3 7 c(kernel) 4 8 a c d 5 b 6 9 (phases c
and d run phase 4 when it is not asked for); phase 6 also times K2' at the
arbitration shape, K1''s shared-target mode at segment_identity's shape
and its carried-state mode at the ring's step shape on 2 ranks.

The last three lines of standard output are the `kernels` JSON line, the
card's `name, power.limit`, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel (its wrapper's launch counter) -> (source, TPU kernel it replaces)
KERNELS = {
    "myers_batch_cuda": ("hga_tpu_torch/csrc/myers_gate.cu",
                         "hga_tpu/ops/myers_pallas.py:47"),
    "myers_batch_cuda_shared": ("hga_tpu_torch/csrc/myers_gate.cu",
                                "hga_tpu/ops/myers_pallas.py:47"),
    "myers_batch_cuda_carry": ("hga_tpu_torch/csrc/myers_gate.cu",
                               "hga_tpu/ops/myers_pallas.py:47"),
    "myers_votes_cuda": ("hga_tpu_torch/csrc/myers_votes.cu",
                         "hga_tpu/ops/myers_pallas.py:106"),
    "myers_votes_cuda_scratch": ("hga_tpu_torch/csrc/myers_votes.cu",
                                 "hga_tpu/ops/myers_pallas.py:106"),
    "myers_batch_planes_cuda": ("hga_tpu_torch/csrc/myers.cu",
                                "hga_tpu/ops/myers_pallas.py:106"),
    "banded_sw_batch_cuda": ("hga_tpu_torch/csrc/sw.cu",
                             "hga_tpu/ops/align_pallas.py:66"),
    "banded_sw_batch_cuda_band": ("hga_tpu_torch/csrc/sw.cu",
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


_PTXAS_ENTRY = (
    # (kind, mangled-name pattern, key of the instantiation from its groups)
    ("K1'", r"myers_gate_kernelILi(\d+)ELi(\d+)E",
     lambda g: f"W{g[0]}G{g[1]}"),
    ("K2", r"myers_kernelILi(\d+)E", lambda g: int(g[0])),
    ("K2'", r"myers_votes_kernelILi(\d+)ELb([01])E",
     lambda g: f"G{g[0]}{'smem' if g[1] == '1' else 'scratch'}"),
    ("K3'", r"sw_diag_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
    ("K3''", r"sw_band_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
    ("K3", r"sw_kernelILb([01])E",
     lambda g: "smem" if g[0] == "1" else "scratch"),
    ("X1", r"myers_slab_kernelILi(\d+)E", lambda g: int(g[0])),
    ("X2", r"swv_kernelILb([01])ELi(\d+)ELi(\d+)ELi(\d+)E",
     lambda g: (f"{'v2' if g[0] == '1' else 'i32'}K{g[1]}G{g[2]}"
                f"f{g[3]}")),
    ("X3", r"vpu_kernelILi(\d+)ELi(\d+)E", lambda g: f"C{g[0]}S{g[1]}"),
)


def ptxas_report(text: str):
    """(kernel, instantiation, registers, (spill store bytes, spill load
    bytes)) per instantiation, from nvcc's -Xptxas -v report: K1' by W and
    lanes a pair, K2 by W, K2' by lanes a pair and plane home, K3' and K3''
    by slots a lane, K3 by buffer kind, X1 by W, X2 by layout, K, G and
    ablation flags, X3 by C and STEPS."""
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

def myers_edges(rng, N, Lq, Lt):
    """Planted pairs with K1's edge cases: qlen 0, 1, 31, 32, 62 and
    Lq - 1 (those that fit), code 4 past qlen, ragged tlen, codes -1, 4 and
    9 in queries and targets."""
    import numpy as np

    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt)
    edge = [x for x in (0, 1, 31, 32, 62, Lq - 1) if x <= Lq]
    ql[:len(edge)] = edge
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl[N // 2:] = rng.integers(0, Lt + 1, N - N // 2)   # ragged targets
    t[8:72, :8] = rng.choice([-1, 4, 9], size=(64, 8))
    q[72:136, :6] = rng.choice([-1, 4, 9], size=(64, 6))
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


def phase_k1_shared(rng, MC, M):
    """K1''s shared-target mode through its wrapper (its own counter must
    move) and, kernel alone, in the other design, against the plain version
    on the same (1, Lt) row."""
    import torch

    errs = []
    cases = [("shared target, segment_identity shape (10 kb genome: "
              "Lq 384, W 13, Lt 20001)", segment_inputs(rng, 10_000)),
             ("shared target W 4 (N 1000, Lq 112, Lt 3000)",
              shared_edges(rng, 1000, 112, 3000)),
             ("shared target W 1 (N 300, Lq 20, Lt 1000)",
              shared_edges(rng, 300, 20, 1000))]
    for label, x in cases:
        args = to_dev(*x)
        t0 = time.perf_counter()
        ref = M.myers_batch(*args)
        torch.cuda.synchronize()
        log(f"  plain version ({label}): {time.perf_counter() - t0:.1f} s")
        W = M.n_words(x[0].shape[1])
        before = MC.LAUNCHES["myers_batch_cuda_shared"]
        got = MC.myers_batch_cuda(*args)
        if MC.LAUNCHES["myers_batch_cuda_shared"] != before + 1:
            fail(f"K1' {label}: myers_batch_cuda_shared did not count")
        errs += [eq(f"K1' {label} G {MC.GATE_GROUP[W]} {f}",
                    getattr(got, f), getattr(ref, f))
                 for f in ("dist", "tend")]
        for other in {1, MC.group_width(W)} - {MC.GATE_GROUP[W]}:
            *ops, outs = MC.kernel_operands(*args, group=other)
            MC.run_kernel(*ops, outs)
            errs += [eq(f"K1' {label} G {other} {f}", o, getattr(ref, f))
                     for f, o in zip(("dist", "tend"), outs)]
    return max(errs)


def phase_k1(rng, MC, M):
    """K1' through its wrapper (GATE_GROUP's lanes a pair) and through the
    other design at each shape, against the plain version."""
    log("phase 2: K1' myers_batch_cuda vs plain, bit-exact, both designs")
    errs = []
    cases = [("long-overlap shape (N 4096, Lq 414, Lt 478)",
              myers_edges(rng, 4096, 414, 478)),
             ("config-3 gate shape (N 4096, Lq 112, Lt 184)",
              gate_inputs(rng))]
    for n, lq, lt in ((1024, 20, 64), (1024, 40, 96), (1024, 112, 184),
                      (1024, 128, 192), (1024, 414, 478), (512, 480, 540),
                      (512, 24 * 31, 800)):        # W 1, 2, 4, 5, 14, 16, 24
        cases.append((f"W {M.n_words(lq)} (N {n}, Lq {lq}, Lt {lt})",
                      myers_edges(rng, n, lq, lt)))
    for label, x in cases:
        args = to_dev(*x)
        ref = M.myers_batch(*args)
        W = M.n_words(x[0].shape[1])
        got = MC.myers_batch_cuda(*args)
        G = MC.GATE_GROUP[W]
        errs += [eq(f"K1' {label} G {G} {f}", getattr(got, f),
                    getattr(ref, f)) for f in ("dist", "tend")]
        for other in {1, MC.group_width(W)} - {G}:
            *ops, outs = MC.kernel_operands(*args, group=other)
            MC.run_kernel(*ops, outs)
            errs += [eq(f"K1' {label} G {other} {f}", o, getattr(ref, f))
                     for f, o in zip(("dist", "tend"), outs)]
    return max(errs)


def phase_k2(rng, MC, M, PU):
    import torch

    log("phase 3: K2 myers_batch_planes_cuda vs plain, bit-exact")
    N, Lq, Lt = 4096, 112, 184
    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt)
    ql[:4] = [0, 31, 62, Lq - 1]
    t[8, :30] = -1
    t[9, 50:90] = 9
    args = to_dev(q, t, ql, tl)
    got, gpv, gmv = MC.myers_batch_planes_cuda(*args)
    ref, rpv, rmv = M.myers_batch_planes(*args)
    errs = [eq("K2 dist", got.dist, ref.dist), eq("K2 tend", got.tend, ref.tend),
            eq("K2 Pv planes", gpv, rpv), eq("K2 Mv planes", gmv, rmv)]
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
    errs.append(eq("K2 traceback votes", votes[0], votes[1]))
    return max(errs)


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
                scratch=False):
    """K2' through its wrapper (the route by shape, whose counter must move
    by one), or forced onto the scratch route, against myers_votes on the
    same inputs: dist, tend and the vote buffer less its sink, which the
    kernel never writes."""
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
    if scratch:
        r, *kops, outs = MC.votes_operands(got_m, *args, scratch=True, **kw)
        MC.run_votes_kernel(r, *kops, outs)
        got = MC.MyersResult(*outs)
    else:
        r = MC.votes_route(Lq, ops[1].shape[1])
        key = MC.votes_counter(r)
        before = MC.LAUNCHES[key]
        got, _ = MC.myers_votes_cuda(got_m, *args, **kw)
        if MC.LAUNCHES[key] != before + 1:
            fail(f"K2' {label}: {key} did not count its launch")
    name = (f"K2' {label} ({'scratch' if r.scratch else 'smem'}, "
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
    W 1, 2, 11, 13 (copy arbitration) and 24 at min_identity 0.75, then the
    scratch route."""
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
    # k 15: W 13, Lt 472, 2 pairs a warp), W 24, and the scratch route
    for n, lq, band in ((4096, 31, 64), (4096, 62, 64), (4096, 320, 64),
                        (4096, 400, 64), (512, 744, 64), (128, 744, 960)):
        ops, nb, lpad = votes_inputs(rng, n, lq, band)
        r = MC.votes_route(lq, lq + band + 8)
        for weighted in (False, True):
            errs[MC.votes_counter(r)].append(votes_check(
                f"W {r.W} (N {n}, Lq {lq}, Lt {lq + band + 8})", MC, PU,
                ops, nb, lpad, 0.75, weighted))
    if len(errs["myers_votes_cuda_scratch"]) < 3:
        fail("band 960 did not take K2''s scratch route")
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


def sw_cases(rng, A):
    """K3', K3'' and K3 checks: the refine's forward and reverse shapes at
    100 bp reads (Lq 112: K3', and K3'' forced on the same inputs) and at
    300 bp reads (Lq 320: K3''), band >= Lq, Lq 1024 and 1100, band 960
    (K3 with the device scratch), K3' at every slot count's edges (Lq 1 ..
    256, and 257) at bands 0, 64, 128 and >= Lq, then K3'' at Lq 257, 320
    and 1024 at the CPU emulator's bands and at K's edges (band + 1 = 32,
    33, 64, 65, 256).  Each case: (label, q, t, qlen, tlen, band, and
    whether K3'' also runs forced)."""
    cases = [(*c, True) for c in refine_cases(rng, A, 4096, 112, 64)]
    cases += [(*c, False) for c in refine_cases(rng, A, 4096, 320, 64)]
    sized = [(512, 40, 60, 200, "band >= Lq"),
             (256, 1024, 1100, 64, "Lq 1024"),
             (256, 1100, 1200, 64, "Lq 1100"),
             (64, 1000, 1000, 960, "band 960 (device scratch)")]
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
        cases.append((f"{label} (N {n}, Lq {lq}, Lt {lt}) band {b}",
                      *sw_edges(rng, n, lq, lt, b), b, False))
    return cases


SW_KERNEL_NAME = {"diag": "K3'", "band": "K3''", "rows": "K3 (rows)"}


def phase_k3(rng, AC, A):
    """Every case through the wrapper, which picks the route by shape: the
    route's counter must move; K3', K3'' and K3 are reported apart, and each
    must have run."""
    log("phase 7: K3', K3'' and K3 banded_sw_batch_cuda vs plain, bit-exact")
    errs = {key: [] for key in AC.ROUTE_COUNTER.values()}
    for label, q, t, ql, tl, band, force_band in sw_cases(rng, A):
        args = to_dev(q, t, ql, tl)
        Lq, Lt = q.shape[1], t.shape[1]
        r = AC.route(Lq, Lt, band)
        key = AC.ROUTE_COUNTER[r.kind]
        before = AC.LAUNCHES[key]
        got = AC.banded_sw_batch_cuda(*args, band=band)
        if AC.LAUNCHES[key] != before + 1:
            fail(f"K3 {label}: the {r.kind} route was not launched")
        ref = A.banded_sw_batch(*args, band=band)
        runs = [(r.kind, tuple(got))]
        if force_band:
            br, *ops, outs = AC.kernel_operands(*args, band=band,
                                                kind="band")
            AC.run_kernel(br, *ops, outs)
            runs.append(("band", outs))
        for kind, res in runs:
            for f, x in zip(("score", "qend", "tend"), res):
                errs[AC.ROUTE_COUNTER[kind]].append(
                    eq(f"{SW_KERNEL_NAME[kind]} {label} {f}", x,
                       getattr(ref, f)))
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
def stage_launches(MC, into: dict):
    """Count the kernel launches made inside the pipeline's arbitrate stage:
    models/pipeline calls ARB.arbitrate_contigs through the module, so a
    wrapper there sees the stage's launches (`into` gets the counter
    deltas).  It changes nothing the stage computes."""
    from hga_tpu_torch.models import arbitration as ARB

    inner = ARB.arbitrate_contigs

    def counted(*a, **kw):
        before = dict(MC.LAUNCHES)
        try:
            return inner(*a, **kw)
        finally:
            for k, v in MC.LAUNCHES.items():
                into[k] = into.get(k, 0) + v - before[k]

    ARB.arbitrate_contigs = counted
    try:
        yield into
    finally:
        ARB.arbitrate_contigs = inner


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
    MC.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    arb = {}
    with stage_launches(MC, arb):
        res, wall = SR.run(pr_s, pr_l, SR.judged_cfg(),
                           os.path.join(workdir, label), device="cuda")
    launches = dict(MC.LAUNCHES)
    log(f"  launches on the main path: {json.dumps(launches)}; in the "
        f"arbitrate stage: {json.dumps(arb)}")
    for name in ("myers_batch_cuda", "myers_votes_cuda"):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    if arb.get("myers_votes_cuda", 0) <= 0:
        fail("K2' (myers_votes_cuda) was never launched in the arbitrate "
             "stage")
    if launches["myers_batch_planes_cuda"]:
        fail("K2 (myers_batch_planes_cuda) ran on the main path, where K2' "
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
        MC.reset_launches()
        t1 = time.perf_counter()
        seg = segment_identity(polished, genome, device="cuda")
        torch.cuda.synchronize()
        seg["seconds"] = round(time.perf_counter() - t1, 3)
        launches = dict(MC.LAUNCHES)
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


def config3_equal(label, pr_s, pr_l, workdir: str, AC):
    """Config 3 (compute_overlaps_cross, refine sw) on cuda and on cpu:
    overlaps.npz and overlaps.paf byte-identical; on cuda the refine must
    go through the route its width takes, and no other."""
    from hga_tpu_torch.models.overlap import compute_overlaps_cross

    cfg = config3_cfg()
    route = AC.route(pr_s.pad_len, pr_s.pad_len + cfg.band + 8,
                     cfg.band).kind
    dirs = {}
    for dev in ("cuda", "cpu"):
        AC.reset_launches()
        t0 = time.perf_counter()
        ov = compute_overlaps_cross(pr_s, pr_l, cfg, device=dev)
        d = dirs[dev] = os.path.join(workdir, f"{label}_{dev}")
        os.makedirs(d)
        ov.save(os.path.join(d, "overlaps.npz"))
        with open(os.path.join(d, "overlaps.paf"), "w") as fh:
            fh.write(ov.to_paf(pr_s.names, pr_l.names))
        log(f"  {dev}: {ov.n} overlaps in {time.perf_counter() - t0:.1f} s"
            f"; SW launches {json.dumps(AC.LAUNCHES)}")
        if ov.n == 0:
            fail(f"config 3 on {dev} found no overlap")
        moved = {k for k, n in AC.LAUNCHES.items() if n}
        want = {AC.ROUTE_COUNTER[route]} if dev == "cuda" else set()
        if moved != want:
            fail(f"config 3 on {dev} (pad {pr_s.pad_len}) launched {moved}, "
                 f"not {want}")
    same_outputs(dirs, ("overlaps.paf",), ("overlaps.npz",))


def phase_cpu_equal(workdir: str, AC):
    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.models.pipeline import run_pipeline

    log("phase 5: the same work on cuda and on cpu, byte-identical")
    log("  the hybrid pipeline, 20 kb genome")
    _, pr_s, pr_l = simulate(20_000, seed=7)
    dirs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        d = dirs[dev] = os.path.join(workdir, f"p5_{dev}")
        res = run_pipeline(pr_s, pr_l, judged_cfg(), d, device=dev)
        log(f"  {dev}: {len(res.polished)} contigs in "
            f"{time.perf_counter() - t0:.1f} s")
        if not res.polished:
            fail(f"{dev} run produced no contig")
    same_outputs(dirs, ("contigs.fasta", "assembly.gfa", "arbitrated.fasta",
                        "polished.fasta"),
                 ("spectrum.npz", "corrected.npz", "overlaps.npz"))

    log("  config 3 (compute_overlaps_cross, refine sw), 8 kb genome")
    _, pr_s, pr_l = simulate(8_000, seed=8)
    config3_equal("p5c3", pr_s, pr_l, workdir, AC)
    log("  config 3 with 300 bp reads (pad 320: the refine on K3''), 8 kb")
    t0 = time.perf_counter()
    config3_equal("p5c3_300", *simulate(8_000, seed=9, read_len=300)[1:],
                  workdir, AC)
    log(f"  config 3 with 300 bp reads: {time.perf_counter() - t0:.1f} s")

    log("  the short-read-only pipeline (refine sw, arbitrate on), 8 kb")
    dirs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        d = dirs[dev] = os.path.join(workdir, f"p5s_{dev}")
        res = run_pipeline(pr_s, None, short_only_cfg(), d, device=dev)
        log(f"  {dev}: {res.stats['candidates']['n']} candidates, "
            f"{res.stats['overlaps']['n']} overlaps, {len(res.polished)} "
            f"contigs in {time.perf_counter() - t0:.1f} s")
        if not res.polished:
            fail(f"short-read-only run on {dev} produced no contig")
    same_outputs(dirs, ("contigs.fasta", "assembly.gfa", "polished.fasta"),
                 ("spectrum.npz", "candidates.npz", "overlaps.npz"))


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
    """Phase b, the scored-SW correction engine (corr_engine="sw", plain
    torch): correct_long_reads on an 8 kb genome, then phase 5's 20 kb
    hybrid pipeline, each on cuda and on cpu, byte-identical; K1' (long
    overlaps) must move on the card and K2' must not.  Returns the
    pipeline's launches on the card."""
    import torch

    from hga_tpu_torch.exp.scale_run import judged_cfg
    from hga_tpu_torch.models import correction as CR
    from hga_tpu_torch.models.pipeline import run_pipeline

    cfg = judged_cfg().replace(corr_engine="sw")
    k2v = ("myers_votes_cuda", "myers_votes_cuda_scratch",
           "myers_batch_planes_cuda")
    log("phase b: corr_engine='sw', correct_long_reads on an 8 kb genome, "
        "cuda and cpu")
    _, pr_s, pr_l = simulate(8_000, seed=8)
    outs = {}
    for dev in ("cuda", "cpu"):
        MC.reset_launches()
        t0 = time.perf_counter()
        outs[dev] = CR.correct_long_reads(pr_s, pr_l, cfg, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"  {dev}: {outs[dev].n_reads} reads in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{CR.LAST_TIMINGS.get('n_batches')} batches, loop "
            f"{CR.LAST_TIMINGS.get('loop_s')} s")
        if any(MC.LAUNCHES[k] for k in k2v):
            fail(f"the sw engine launched a Myers planes kernel on {dev}: "
                 f"{json.dumps(MC.LAUNCHES)}")
    same_reads("correct_long_reads(corr_engine='sw'), cuda vs cpu",
               outs["cuda"], outs["cpu"])
    log("  ok: corrected reads equal on cuda and cpu")

    log("phase b: corr_engine='sw', the hybrid pipeline, 20 kb genome")
    _, pr_s, pr_l = simulate(20_000, seed=7)
    dirs, launches = {}, {}
    for dev in ("cuda", "cpu"):
        MC.reset_launches()
        AC.reset_launches()
        t0 = time.perf_counter()
        d = dirs[dev] = os.path.join(workdir, f"pb_sw_{dev}")
        res = run_pipeline(pr_s, pr_l, cfg, d, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(MC.LAUNCHES, **AC.LAUNCHES)
        stages = {k: v["seconds"] for k, v in res.stats["stages"].items()}
        log(f"  {dev}: {len(res.polished)} contigs in "
            f"{time.perf_counter() - t0:.1f} s; stages {json.dumps(stages)}"
            f"; correction {json.dumps(res.stats.get('correction_detail'))}")
        if not res.polished:
            fail(f"the sw-engine pipeline on {dev} produced no contig")
    log(f"  launches on the card: {json.dumps(launches)}")
    if launches["myers_batch_cuda"] <= 0:
        fail("K1' (myers_batch_cuda) was never launched by the sw-engine "
             "pipeline's long overlaps")
    if any(launches[k] for k in k2v):
        fail("the sw-engine pipeline launched K2'/K2")
    same_outputs(dirs, ("contigs.fasta", "assembly.gfa", "arbitrated.fasta",
                        "polished.fasta"),
                 ("spectrum.npz", "corrected.npz", "overlaps.npz"))
    return launches


def bench_correction_path(cli, MC):
    """`hga-torch bench --what correction --pairs 4096` through cli.main:
    both engines (K2' for myers, whose counter must move)."""
    buf = io.StringIO()
    MC.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--what", "correction", "--pairs", "4096"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    launches = dict(MC.LAUNCHES)
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
    MC.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["correct", "--short", s, "--long", lr, "-k", "15",
                       "-w", "5", "--band", "64", "-o",
                       os.path.join(workdir, "pb_corr"), "--profile", prof])
    launches = dict(MC.LAUNCHES)
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
    """Phase b: the native reader, the sw correction engine, bench
    --what correction, --profile and spectrum.png.  Returns {path:
    launches}."""
    from hga_tpu_torch import cli

    tb = time.perf_counter()
    phase_native(genome_len, workdir)
    log(f"  native reader: {time.perf_counter() - tb:.1f} s")
    t0 = time.perf_counter()
    paths = {"phase b sw-engine pipeline": phase_sw_engine(workdir, MC, AC)}
    log(f"  sw engine: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, paths["phase b bench correction"] = bench_correction_path(cli, MC)
    log(f"  bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, paths["phase b correct --profile"] = phase_profile(cli, workdir, MC)
    log(f"  profile and count: {time.perf_counter() - t0:.1f} s")
    log(f"  phase b: {time.perf_counter() - tb:.1f} s")
    return paths


# ---------------------------------------------------------------- phase c

def carry_chain(MC, M, args, cuts):
    """K1''s carried-state mode over consecutive column chunks of widths
    `cuts` from a fresh state; returns (state, MyersResult)."""
    q, t, ql, tl = args
    st = M.myers_init_state(ql, M.n_words(q.shape[1]))
    j0, res = 0, None
    for c in cuts:
        st, res = MC.myers_cols_cuda(q, t[:, j0:j0 + c].contiguous(), ql, tl,
                                     st, j0)
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
    before = MC.LAUNCHES["myers_batch_cuda_carry"]
    cases = [("segment_identity shape (W 13, shared row, 4 kb genome: "
              "Lt 8001)", segment_inputs(rng, 4_000)),
             ("long-overlap shape (W 14, per-pair rows: N 4096, Lq 414, "
              "Lt 478)", myers_edges(rng, 4096, 414, 478)),
             ("shared-row edges (W 4: N 1000, Lq 112, Lt 3000)",
              shared_edges(rng, 1000, 112, 3000)),
             ("per-pair edges (W 1: N 1024, Lq 20, Lt 64)",
              myers_edges(rng, 1024, 20, 64))]
    for label, x in cases:
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
        for cuts in splits:
            st_c, res_c = carry_chain(MC, M, args, cuts)
            tag = f"carry {label} over {len(cuts)} chunks"
            errs += [eq(f"{tag}: state", torch.stack([x.flatten() for x in
                                                      st_c[2:]]),
                        torch.stack([x.flatten() for x in st[2:]])),
                     eq(f"{tag}: pv, mv", torch.cat(st_c[:2], 1),
                        torch.cat(st[:2], 1)),
                     eq(f"{tag}: dist", res_c.dist, one.dist),
                     eq(f"{tag}: tend", res_c.tend, one.tend)]
    moved = MC.LAUNCHES["myers_batch_cuda_carry"] - before
    if moved <= 0:
        fail("myers_batch_cuda_carry did not count")
    log(f"  myers_batch_cuda_carry moved by {moved}")
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
    MC.reset_launches()
    arb = {}
    t0 = time.perf_counter()
    with stage_launches(MC, arb):
        res = run_pipeline(pr_s, pr_l, judged_cfg(),
                           os.path.join(outdir, f"run{HP.pid()}"),
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(MC.LAUNCHES)
    genome = "".join(r.seq for r in iter_records(genome_fa))
    MC.reset_launches()
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
                segments=seg, segment_launches=dict(MC.LAUNCHES))


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
    artifacts, segment_identity through the ring against one rank; a world
    of 1 on NCCL (`torchrun --nproc-per-node 1 ... eval --segs`); `bench
    --what scaling` on 1 (NCCL) and 2 (gloo) ranks and `--what comm`.
    Returns {path: launches}."""
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
            if o["launches"][name] <= 0:
                fail(f"rank {r}: {name} never launched in the pipeline")
        if o["arbitrate_launches"].get("myers_votes_cuda", 0) <= 0:
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
        if o["segment_launches"]["myers_batch_cuda_carry"] <= 0:
            fail(f"rank {r}: the ring did not launch the carried-state mode")
        paths[f"phase c ring segment_identity, rank {r}"] = \
            o["segment_launches"]
    log(f"  ok: segment_dist {one['segment_dist']} on 2 ranks == 1 rank "
        f"({one['n_segments']} segments)")

    # a world of 1 on NCCL, as a user runs it
    t0 = time.perf_counter()
    got, text = run_cli(["eval", "--contigs", contigs_fa, "--reference",
                         genome_fa, "--segs"], nproc=1)
    if "backend nccl" not in text:
        fail("torchrun --nproc-per-node 1 did not take NCCL")
    if got["segment_dist"] != one["segment_dist"]:
        fail(f"eval --segs on NCCL: {got['segment_dist']} != "
             f"{one['segment_dist']}")
    log(f"  ok: torchrun --nproc-per-node 1 eval --segs on NCCL: "
        f"segment_dist {got['segment_dist']} ({time.perf_counter() - t0:.1f}"
        " s)")

    bench = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        bench[n], text = run_cli(["bench", "--what", "scaling"], nproc=n)
        want = "nccl" if n == 1 else "gloo"
        if f"backend {want}" not in text:
            fail(f"bench --what scaling on {n} ranks did not take {want}")
        log(f"  bench --what scaling, {n} rank(s) ({want}): "
            f"{json.dumps(bench[n])} ({time.perf_counter() - t0:.1f} s)")
    if "not a scaling figure" not in bench[2].get("note", ""):
        fail("the 2-rank scaling figure does not say it shares one card")
    comm, _ = run_cli(["bench", "--what", "comm"])
    log(f"  bench --what comm: {json.dumps(comm)}")
    log(f"  phase c distribution: {time.perf_counter() - tc:.1f} s")
    return paths, dict(ranks=ranks, one_rank=p4["out"], scaling=bench,
                       comm=comm)


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
    MC.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), script_logging():
        ret = mod.main(list(argv))
    torch.cuda.synchronize()
    launches = dict(MC.LAUNCHES)
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
                  seed: int = 42):
    """Judged config 3 on the card: short reads of the judged read model
    against its long reads, refine sw; precision against the truth loci.
    The refine's width (the short reads' pad) picks the SW route: K3' at
    100 bp reads (pad 112), K3'' at 300 bp reads (pad 320, forward band 64
    and reverse band 128 both on it); the other routes' counters must stay
    at 0.  The 100 bp drive counts a record right when
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
    cfg = config3_cfg()
    # the refine's widths: Lq = the pad, Lt = Lq + band + 8 (models/overlap)
    route = AC.route(pr_s.pad_len, pr_s.pad_len + cfg.band + 8,
                     cfg.band).kind
    log(f"  {pr_s.n_reads} short (pad {pr_s.pad_len}: SW route {route}) + "
        f"{pr_l.n_reads} long reads ({time.perf_counter() - t0:.1f} s to "
        "simulate or reuse)")
    MC.reset_launches()
    AC.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = OV.compute_overlaps_cross(pr_s, pr_l, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(MC.LAUNCHES, **AC.LAUNCHES)
    for name in ("myers_batch_cuda", AC.ROUTE_COUNTER[route]):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the config-3 path")
    for kind, name in AC.ROUTE_COUNTER.items():
        if kind != route and launches[name]:
            fail(f"{name} ran {launches[name]} times at the {route} route's "
                 "width")
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
    out = dict(genome_len=genome_len, read_len=read_len,
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


def time_row(shape, wrapper, sets, kernel, kernel_sets, plain, cells, ops,
             nbytes, counters):
    """CUDA-event times of a wrapper and of its kernel alone (20 calls over
    distinct input sets, warm) and of the plain version (one call), the
    bound from `ops` int32 operations and `nbytes` bytes and the kernel's
    share of it, GCUPS on `cells`.  Launches made here are no path's: the
    counters are restored."""
    from hga_tpu_torch.utils import benchmarks as B

    before = [dict(c) for c in counters]
    ms = B.cuda_ms(wrapper, sets, 20)
    kern_ms = B.cuda_ms(kernel, kernel_sets, 20)
    plain_ms = B.cuda_ms(plain, sets[:1], 1)
    for c, b in zip(counters, before):
        c.update(b)
    bound, by = B.bound_ms(ops, nbytes)
    row = dict(shape=shape, ms=ms, kernel_ms=kern_ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=by,
               pct_of_bound=100 * bound / kern_ms)
    if cells:
        row.update(cells=int(cells), gcups=cells / (ms * 1e-3) / 1e9,
                   kernel_gcups=cells / (kern_ms * 1e-3) / 1e9)
    return row


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
                   M.myers_batch, cells, ops, nbytes, [MC.LAUNCHES])
    row.update(zip(("registers", "local_bytes"), MC.kernel_attrs(W, group=G)),
               blocks=MC.gate_blocks(N, G), designs={})
    for g in sorted({1, MC.group_width(W)}):
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
                       0, ops, nbytes, [MC.LAUNCHES])
    full = [to_dev(*segment_inputs(rng, genome_len)) for _ in range(2)]
    shape, ops, nbytes = cost(full)
    before = dict(MC.LAUNCHES)
    ms = B.cuda_ms(MC.myers_batch_cuda, full, 3)
    kern_ms = B.cuda_ms(MC.run_kernel, [MC.kernel_operands(*a) for a in full],
                        3)
    MC.LAUNCHES.update(before)
    bound, by = B.bound_ms(ops, nbytes)
    regs, local = MC.kernel_attrs(shape["W"])
    return dict(shape=shape, ms=ms, kernel_ms=kern_ms,
                plain_ms=cut_row["plain_ms"], plain_shape=cut_row["shape"],
                bound_ms=bound, bound_by=by,
                pct_of_bound=100 * bound / kern_ms, registers=regs,
                local_bytes=local, blocks=MC.gate_blocks(shape["N"],
                                                         shape["G"]),
                cut_shape=cut_row)


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
                       nbytes, [MC.LAUNCHES])
    full = sets_of(genome_len)
    shape, ops, nbytes = cost(full)
    before = dict(MC.LAUNCHES)
    ms = B.cuda_ms(MC.myers_cols_cuda, full, 3)
    kern_ms = B.cuda_ms(MC.run_carry_kernel,
                        [MC.carry_operands(*a) for a in full], 3)
    MC.LAUNCHES.update(before)
    bound, by = B.bound_ms(ops, nbytes)
    regs, local = MC.kernel_attrs(shape["W"])
    return dict(shape=shape, ms=ms, kernel_ms=kern_ms,
                plain_ms=cut_row["plain_ms"], plain_shape=cut_row["shape"],
                bound_ms=bound, bound_by=by,
                pct_of_bound=100 * bound / kern_ms, registers=regs,
                local_bytes=local, blocks=MC.gate_blocks(shape["N"],
                                                         shape["G"]),
                cut_shape=cut_row)


def phase_times(rng, MC, M, PU, genome_len: int):
    import torch

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
    sets = [to_dev(*planted_pairs(rng, 4096, 112, 184)) for _ in range(4)]
    rows["myers_batch_planes_cuda"] = time_row(
        dict(N=4096, Lq=112, Lt=184, W=4), MC.myers_batch_planes_cuda, sets,
        MC.run_planes_kernel, [MC.planes_operands(*a) for a in sets],
        M.myers_batch_planes, *myers_cost(4096, 112, 184, True),
        [MC.LAUNCHES])
    rows["myers_batch_planes_cuda"].update(
        zip(("registers", "local_bytes"), MC.kernel_attrs(4, planes=True)),
        blocks=-(-4096 // MC.THREADS))
    rows["myers_votes_cuda"], split = votes_times(rng, MC, PU, CR)
    # copy arbitration's chunk batches: Lq 400 (W 13, 2 pairs a warp), Lt
    # 472, planted pairs at ~10% edits, unweighted (chunks carry no quality)
    arb = [votes_inputs(rng, 4096, 400, 64) for _ in range(2)]
    rows["myers_votes_cuda"]["arbitration_shape"], _, _ = votes_row(
        MC, PU, [to_dev(*ops)[:7] for ops, _, _ in arb], arb[0][1],
        arb[0][2], judged_cfg().min_identity)
    rows["myers_batch_cuda_shared"] = shared_row(rng, MC, M, genome_len)
    rows["myers_batch_cuda_carry"] = carry_row(rng, MC, M, genome_len)
    # the scratch route where the shape takes it: W 24, band 960
    big = [votes_inputs(rng, 256, 744, 960) for _ in range(2)]
    rows["myers_votes_cuda_scratch"], _, _ = votes_row(
        MC, PU, [to_dev(*ops)[:7] for ops, _, _ in big], big[0][1],
        big[0][2], judged_cfg().min_identity)
    for name, r in rows.items():
        log(f"  {name}: {json.dumps(r)}")
    log(f"  correction batch (N 4096, Lq 112, Lt 184): {json.dumps(split)}")
    return rows, split


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


def votes_row(MC, PU, sets, nb, lpad, min_identity):
    """K2' on batches (q, t, qlen, tlen, bb, off, lb), unweighted: the
    wrapper, the kernel alone and the plain version; the bound counts this
    run's work — the DP's N Lt W words, each gated pair's walk (its qlen
    diag/up moves and at most dist left moves) and one 4-byte atomic per
    vote cast — and the route's registers, shared memory a block and blocks
    resident an SM."""
    import torch

    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * 3 * 4
    kw = dict(min_identity=min_identity, size_v=size_v, lpad=lpad,
              ins_slots=3, max_steps=Lq + int((1.0 - min_identity) * Lq) + 2)
    steps = votes = gated = 0
    for a in sets:
        m = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
        res, _ = PU.myers_votes(m, *a, **kw)
        ql = a[2]
        ok = (res.dist <= PU.gate_max_ed(ql, min_identity)) & (ql > 0) \
            & (res.tend > 0)
        gated += int(ok.sum()) / len(sets)
        steps += int((ql.long() + res.dist)[ok].sum()) / len(sets)
        votes += int(m[:size_all].sum()) / len(sets)
    cells, ops, nbytes = myers_cost(N, Lq, Lt, False)
    ops += steps * B.OPS_PER_WALK_STEP
    nbytes += 4 * 3 * N + 4 * votes
    merged = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
    r = MC.votes_route(Lq, Lt)
    row = time_row(
        dict(N=N, Lq=Lq, Lt=Lt, W=r.W, G=r.G, min_identity=min_identity,
             gated=gated, walk_steps=steps, votes=votes,
             route="scratch" if r.scratch else "smem"),
        lambda *a: MC.myers_votes_cuda(merged, *a, **kw), sets,
        MC.run_votes_kernel, [MC.votes_operands(merged, *a, **kw)
                              for a in sets],
        lambda *a: PU.myers_votes(merged.clone(), *a, **kw), cells, ops,
        nbytes, [MC.LAUNCHES])
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
    n_before = dict(MC.LAUNCHES)
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
    MC.LAUNCHES.update(n_before)
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


def swept_slot_steps(r, sets, Lq, Lt, band):
    """Slot-steps a K3' or K3'' launch sweeps, a set on average: 32 K per
    anti-diagonal up to each pair's last in-band one (K3' from d = 2, K3''
    in pairs of steps from d = 2 - (band & 1))."""
    import numpy as np

    band = min(band, max(Lq, Lt))
    ql = np.clip(np.concatenate([x[2] for x in sets]), 0, Lq).astype(
        np.int64)
    tl = np.minimum(np.concatenate([x[3] for x in sets]), Lt)
    dend = np.where(ql >= 1, ql + np.minimum(tl, ql + band), 1)
    if r.kind == "diag":
        steps = (dend - 1).clip(min=0)
    else:
        d0 = 2 - (band & 1)
        steps = np.where(dend >= d0, 2 * ((dend - d0) // 2 + 1), 0)
    return 32 * r.K * steps.sum() / len(sets)


def sw_row(AC, A, sets, band, kind=None):
    """One SW timing row: the wrapper and the kernel alone of the route the
    shape takes, GCUPS on in-band cells, the bound; for K3' and K3'' the
    share of the swept slot-steps in band; beside it the kernels of the
    other routes on the same inputs (K3 always, K3'' beside K3').  With
    `kind` ("rows"), the row is that route's, forced: "ms" then times its
    operand prep and launch, the work the wrapper would do there."""
    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    dev_sets = [to_dev(*x) for x in sets]
    cells = sum(A.sw_cells(x[2], x[3], band) for x in sets) / len(sets)
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
        [AC.LAUNCHES])
    row.update(zip(("registers", "local_bytes"), AC.kernel_attrs(r)),
               K=r.K, warps=r.warps, smem=r.smem)
    row["blocks"] = -(-N // r.warps) if r.kind != "rows" else \
        -(-N // AC.THREADS)
    if r.kind != "rows":
        row["in_band_share"] = cells / swept_slot_steps(r, sets, Lq, Lt,
                                                        band)
        beside = ("band", "rows") if r.kind == "diag" else ("rows",)
        for other in beside:
            # kernel alone of another route on the same inputs
            row[f"{other}_kernel_ms"] = B.cuda_ms(
                AC.run_kernel, [AC.kernel_operands(*x, band=band, kind=other)
                                for x in dev_sets], 20, passes=3)
    return row


def phase_times_k3(rng, AC, A):
    """K3' at the 100 bp refine's shapes (Lq 112: forward band 64, reverse
    band 128) beside the K3'' and K3 kernels on the same inputs; K3'' at
    the 300 bp refine's shapes (Lq 320) beside K3's kernel; K3's row,
    forced at Lq 320 (no main path takes the row route now)."""
    log("phase 6: K3', K3'' and K3 times (CUDA events, distinct inputs, "
        "warm)")
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
    for key, row in rows.items():
        log(f"  {key}: {json.dumps(row)}")
    return rows


SW_FIELDS = ("score", "qend", "tend")


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
    # X1 at the harness's main() shapes, then a ragged case: a partial
    # block (N 1000) and slab (Lt 190), qlen 0..Lq with code 4 past it,
    # ragged tlen, codes -1/4/9 in the targets
    errs = []
    for N, Lq, Lt, BLK, S in MM.SHAPES[:2]:
        ops, (q, t, ql, tl) = MM.prep(N, Lq, Lt, "cuda")
        got, ref = MM.run_b(*ops, S=S, BLK=BLK), M.myers_batch(q, t, ql, tl)
        errs += [eq(f"X1 N {N} Lq {Lq} Lt {Lt} {f}", getattr(got, f),
                    getattr(ref, f)) for f in ("dist", "tend")]
    N, Lq, Lt = 1000, 128, 190
    q, t, _, _ = planted_pairs(rng, N, Lq, Lt)
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:4] = [0, 31, 62, Lq]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    t[:64, :8] = rng.choice([-1, 4, 9], size=(64, 8))
    qd, td, qld, tld = to_dev(q, t, ql, tl)
    planes = M.query_planes(qd, qld, M.n_words(Lq))
    ref = M.myers_batch(qd, td, qld, tld)
    for S, BLK in ((8, 32), (2, 8)):
        got = MM.run_b(qld, tld, *planes, td, S=S, BLK=BLK)
        errs += [eq(f"X1 ragged (N {N}, Lt {Lt}) S {S} BLK {BLK} {f}",
                    getattr(got, f), getattr(ref, f))
                 for f in ("dist", "tend")]
    err["run_b_cuda"] = max(errs)
    # X2 at check()'s shape and at K3's refine shapes (forward band 64 and
    # reverse band 128, ragged, homopolymer and ACAC tie rows; band >= Lq)
    cases = [("check() shape (N 256, Lq 128, Lt 256) band 64",
              *SV.planted_inputs(256, 128, 256), 64),
             *refine_cases(rng, A, 4096, 112, 64),
             ("band >= Lq (N 512, Lq 40, Lt 60) band 200",
              *sw_edges(rng, 512, 40, 60, 200), 200)]
    errs = {v: [] for v in ("v1", "v2", "v3")}
    for label, q, t, ql, tl, band in cases:
        args = to_dev(q, t, ql, tl)
        ref = A.banded_sw_batch(*args, band=band)
        for v in ("v1", "v2", "v3", "v3g2"):
            got = SV.sw_pallas_exp(*args, band=band, variant=v)
            errs[v[:2]] += [eq(f"X2 {v} {label} {f}", getattr(got, f),
                               getattr(ref, f)) for f in SW_FIELDS]
    for v, e in errs.items():
        err[f"sw_variants_{v}"] = max(e)
    return err


def sass_dpx(cuda_build):
    """{instantiation: counts of the integer max/add-max instructions, and
    of all instructions} of X2's SASS: whether the DPX forms (VIADDMNMX,
    VIMNMX) appear, and how long each instantiation's code is."""
    import re

    out = {}
    for fn, ops in cuda_build.sass_opcodes("sw_variants").items():
        m = re.search(r"swv_kernelILb([01])ELi(\d+)ELi(\d+)ELi(\d+)E", fn)
        if m:
            key = (f"{'v2' if m.group(1) == '1' else 'i32'} K{m.group(2)} "
                   f"G{m.group(3)} flags{m.group(4)}")
            out[key] = {op: n for op, n in sorted(ops.items())
                        if op in ("VIADDMNMX", "VIMNMX", "VIMNMX3", "IMNMX",
                                  "VIADD", "VHMNMX")}
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


def x_times(x3_rows, x1_rows, sv_rows, VM, MM, SV, M, A):
    """The X rows of the kernels line: each kernel beside its plain version
    and its bound at the harness's timing shape, and beside K1 or K3 at the
    same shape (from the harnesses' own rows)."""
    import numpy as np
    import torch

    from hga_tpu_torch.utils import benchmarks as B

    counters = [VM.LAUNCHES, MM.LAUNCHES, SV.LAUNCHES]
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
        [MM.kernel_operands(*a, S=S) for a in sets],
        lambda ql, tl, q0, q1, vq, mend, t: M.myers_batch_from_planes(
            q0, q1, vq, mend, t, ql, tl),
        N * Lq * Lt, N * Lt * W * B.OPS_PER_WORD_COLUMN,
        16 * N * W + 4 * N * Lt + 8 * N + 8 * N, counters)
    rows["run_b_cuda"].update(zip(("registers", "local_bytes"),
                                  MM.kernel_attrs(W)))
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
            cells * B.SW_OPS_PER_CELL, 4 * N * (Lq + Lt) + 8 * N + 12 * N,
            counters)
        rows[f"sw_variants_{v}"].update(zip(("registers", "local_bytes"),
                                            SV.kernel_attrs(v, Lq)))
        beside = next(r for r in sv_rows if r["variant"] == v)
        rows[f"sw_variants_{v}"]["beside_k3"] = {
            k: beside[k] for k in ("k3_ms", "k3_kernel_ms", "kernel_ms")}
    rows["sw_variants_v1"]["ablations"] = {
        r["variant"]: {k: r[k] for k in ("ms", "kernel_ms", "gcups")}
        for r in sv_rows if "no" in r["variant"]}
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
        instr * elems, 8 * elems, counters)
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
    for mod in (VM, MM, SV):
        mod.reset_launches()
    t0 = time.perf_counter()
    x3_rows = VM.main([])
    x1_rows = MM.main([])
    sv_rows = SV.main(["--time", "--variants",
                       "v1,v2,v3,v3g2,v1nots,v1nos1,v1nomask,v1nobest"])
    harness = dict(VM.LAUNCHES, **MM.LAUNCHES, **{
        f"sw_variants_{k}": n for k, n in SV.LAUNCHES.items()})
    log(f"  harnesses ({time.perf_counter() - t0:.1f} s), launches: "
        f"{json.dumps(harness)}")
    for name in ("vpu_chains_cuda", "run_b_cuda", "sw_variants_v1",
                 "sw_variants_v2", "sw_variants_v3",
                 "sw_variants_v1_ablation"):
        if harness[name] <= 0:
            fail(f"{name} was never launched by the harnesses")
    if not all(r["ok"] for r in x1_rows):
        fail("myers_micro main(): X1 differs from the plain version")
    if not all("share" in r for r in x3_rows if "C" in r):
        fail("vpu_micro main(): no SASS add/max count")
    MC.reset_launches()
    AC.reset_launches()
    t0 = time.perf_counter()
    bench = bench_path(cli)
    launches = dict(MC.LAUNCHES, **AC.LAUNCHES)
    log(f"  bench ({time.perf_counter() - t0:.1f} s), launches: "
        f"{json.dumps(launches)}")
    for name in ("myers_batch_cuda", "banded_sw_batch_cuda"):
        if launches[name] <= 0:
            fail(f"{name} was never launched by hga-torch bench")
    rows = x_times(x3_rows, x1_rows, sv_rows, VM, MM, SV, M, A)
    rows["dpx"] = dpx
    log(f"  phase 9: {time.perf_counter() - t9:.1f} s")
    paths = {"phase 9 harnesses": harness, "phase 9 bench": launches}
    return err, paths, rows, bench


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-len", type=int, default=1_000_000,
                    help="genome length of phases 4, 8 and 10 (default "
                         "1,000,000 bp)")
    ap.add_argument("--phases", default="0123456789abcd",
                    help="phases to run, 'a' for phase 10, 'b', 'c' and "
                         "'d' for phases b, c and d (default all)")
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
    for mod in (MC, AC, VM, MM, SV):
        mod._lib()
    MC._gate_lib()
    MC._votes_lib()
    log(f"phase 1: built {len(libs)} libraries (one nvcc each, in parallel) "
        f"in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{os.path.relpath(p, HERE)} {built[n]['seconds']:.1f} s"
            for n, p in libs.items()))
    report = ptxas_report("".join(str(b["ptxas"]) for b in built.values()))
    expect = ((2 * M.MAX_WORDS - 1) + M.MAX_WORDS + 2 * 6
              + len(AC.DIAG_SLOTS) + len(AC.BAND_SLOTS) + 2
              + M.MAX_WORDS + sum(len(k) for k in SV.BUILT.values())
              + len(VM.BUILT))
    log(f"  ptxas report: {len(report)} of {expect} kernel instantiations "
        "parsed")
    for kern, by in (("K1'", "W, lanes a pair"), ("K2", "W"),
                     ("K2'", "lanes a pair, plane home"),
                     ("K3'", "slots a lane"), ("K3''", "slots a lane"),
                     ("K3", "buffer"), ("X1", "W"),
                     ("X2", "layout"), ("X3", "C, STEPS")):
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
    if "2" in ph:
        err["myers_batch_cuda"] = phase_k1(rng, MC, M)
        err["myers_batch_cuda_shared"] = phase_k1_shared(rng, MC, M)
        done("2")
    if "3" in ph:
        err["myers_batch_planes_cuda"] = phase_k2(rng, MC, M, PU)
        err.update(phase_k2v(rng, MC, PU))
        done("3")
    if "7" in ph:
        err.update(phase_k3(rng, AC, A))
        done("7")
    if "c" in ph:
        err["myers_batch_cuda_carry"] = phase_carry(rng, MC, M)
        done("c (kernel)")
    torch.cuda.synchronize()

    # launches per kernel on each path that ran: K1' and K2' on the hybrid
    # pipeline (phases 4 and 10), K1' and K3' on config 3 and K1' and K3'' on
    # its 300 bp drive (phase 8), K1''s shared-target mode on
    # segment_identity (phase 10), X1-X3 on the harnesses and K1'/K3' on
    # hga-torch bench (phase 9)
    workdir = tempfile.mkdtemp(prefix="hga_smoke_")
    paths = {}
    try:
        p4 = None
        if "4" in ph or "c" in ph or "d" in ph:
            paths["phase 4 hybrid pipeline"], p4 = phase_pipeline(
                args.genome_len, MC, workdir)
            done("4")
        if "8" in ph:
            paths["phase 8 config 3"], _ = phase_config3(args.genome_len,
                                                         MC, AC)
            paths["phase 8 config 3, 300 bp reads"], _ = phase_config3(
                MISEQ_GENOME, MC, AC, read_len=300, seed=44)
            done("8")
        if "a" in ph:
            paths.update(phase_genomes(args.genome_len, kinds, MC, workdir))
            done("10")
        if "c" in ph:
            c_paths, _ = phase_distributed(args.genome_len, workdir, p4)
            paths.update(c_paths)
            done("c")
        if "d" in ph:
            paths.update(phase_scripts(args.genome_len, workdir, p4, MC))
            done("d")
        if "5" in ph:
            phase_cpu_equal(workdir, AC)
            done("5")
        if "b" in ph:
            paths.update(phase_b(args.genome_len, workdir, MC, AC))
            done("b")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # every kernel in the line, each value null where its phase did not run
    entries = {name: dict(
        name=name, route="cuda", source=src, replaces=rep, launches=None,
        launches_by_path={}, max_abs_err=None, matches_plain=None, ms=None,
        kernel_ms=None, plain_ms=None, bound_ms=None, bound_by=None,
        library_ms=None, gcups=None, shape=None, registers=None,
        local_bytes=None) for name, (src, rep) in KERNELS.items()}
    if "6" in ph:
        rows, split = phase_times(rng, MC, M, PU, args.genome_len)
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
        "add/max chains: library_ms is null")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
