#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (hga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, 1 Mb genome
    python3 chip_smoke.py --genome-len 4600000

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. card facts: nvidia-smi name/power limit, torch and CUDA versions
  1. build the CUDA kernels from hga_tpu_torch/csrc (one nvcc per source,
     in parallel, sm_90a), timed; registers/spills per instantiation
  2. K1 (myers_batch_cuda) == its plain PyTorch version, bit-exact, at the
     long-overlap shape (N 4096, Lq 414, Lt 478), the config-3 gate shape
     (N 4096, Lq 112, Lt 184, ragged, code-4 padding) and on edge cases
  3. K2 (myers_batch_planes_cuda) == its plain version (dist, tend, Pv, Mv)
     at the correction shape (N 4096, Lq 112, Lt 184), and the traceback
     votes made from each set of planes are equal
  4. the port's main path, run_pipeline(device="cuda"), on a simulated
     genome with the judged read model; both kernels' launch counters must
     move; per-stage seconds, contigs, N50, k-mer identity (>= 0.99) and
     genome fraction
  5. the same pipeline on a ~20 kb genome on cuda and on cpu: artifacts
     byte-identical / array-equal
  6. CUDA-event times of each kernel (wrapper and kernel alone) and of its
     plain version at the phase 2-3 and 7 shapes, GCUPS, bounds, and the
     correction batch split (K2 + gate / traceback)
  7. K3 (banded_sw_batch_cuda) == its plain version, bit-exact, at the
     refine's forward (N 4096, Lq 112, Lt 184, band 64) and reverse (band
     128, ragged) shapes and on edge cases (Lq 1024 and 1100, device
     scratch)
  8. judged config 3, compute_overlaps_cross(device="cuda") with the SW
     refine, on the phase-4 reads: K1 and K3 counters must move; truth
     precision >= 0.95

Phase 5 also runs config 3 and the short-read-only pipeline (8 kb genome)
on cuda and on cpu, byte-identical.  Phases run in the order 0 1 2 3 7 4 8
5 6.

The last three lines of standard output are the `kernels` JSON line, the
card's `name, power.limit`, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks used for bounds (NVIDIA data sheet): HBM3 3.35 TB/s; int32
# ALU issue 64 lanes per SM per clock x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per word, target column and pair in the Myers recurrence
# after the compiler's 3-input logic fusion (about 37 source-level ops)
OPS_PER_WORD_COLUMN = 20
# int32 operations per in-band cell of the SW recurrence (the Pallas
# kernel's CostEstimate, hga_tpu/ops/align_pallas.py:222)
SW_OPS_PER_CELL = 12

SOURCES = {"myers_batch_cuda": "hga_tpu_torch/csrc/myers.cu",
           "myers_batch_planes_cuda": "hga_tpu_torch/csrc/myers.cu",
           "banded_sw_batch_cuda": "hga_tpu_torch/csrc/sw.cu"}
REPLACES = {"myers_batch_cuda": "hga_tpu/ops/myers_pallas.py:47",
            "myers_batch_planes_cuda": "hga_tpu/ops/myers_pallas.py:106",
            "banded_sw_batch_cuda": "hga_tpu/ops/align_pallas.py:66"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_report(text: str):
    """(kernel, W or K3's buffer kind, registers, (spill store bytes, spill
    load bytes)) per instantiation, from nvcc's -Xptxas -v report."""
    import re

    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*myers_kernel"
                      r"ILi(\d+)ELb([01])E", line)
        m3 = re.search(r"Compiling entry function '.*sw_kernelILb([01])E",
                       line)
        if m or m3:
            cur = ([("K2" if m.group(2) == "1" else "K1"), int(m.group(1)),
                    0, (0, 0)] if m else
                   ["K3", "smem" if m3.group(1) == "1" else "scratch",
                    0, (0, 0)])
            rows.append(cur)
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
    ql[: N // 8] = rng.integers(1, Lq, N // 8)       # ragged lengths
    tl = np.full(N, Lt, np.int32)
    return q, t, ql, tl


def to_dev(*xs):
    import torch

    return tuple(torch.from_numpy(x).cuda() for x in xs)


# ---------------------------------------------------------------- phases

def phase_k1(rng, MC, M):
    import numpy as np

    log("phase 2: K1 myers_batch_cuda vs plain, bit-exact")
    errs = []
    N, Lq, Lt = 4096, 414, 478
    q, t, ql, tl = planted_pairs(rng, N, Lq, Lt)
    ql[:4] = [0, 31, 62, Lq - 1]                     # word-boundary lengths
    tl[: N // 8] = rng.integers(1, Lt + 1, N // 8)    # ragged targets
    t[8, :40] = -1                                   # sentinel codes
    t[9, 100:140] = 4
    t[10, 200:260] = 9
    args = to_dev(q, t, ql, tl)
    got = MC.myers_batch_cuda(*args)
    ref = M.myers_batch(*args)
    errs += [eq("K1 gate-shape dist", got.dist, ref.dist),
             eq("K1 gate-shape tend", got.tend, ref.tend)]
    # the config-3 gate (models/overlap._myers_gate): short-read segments of
    # ragged length padded with code 4, windows of Lq + band + 8 that run
    # off the long read's ends (code 4), every tlen the full window
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
    args = to_dev(q, t, ql, tl)
    got = MC.myers_batch_cuda(*args)
    ref = M.myers_batch(*args)
    errs += [eq("K1 config-3 gate shape (Lq 112, W 4) dist", got.dist,
                ref.dist),
             eq("K1 config-3 gate shape (Lq 112, W 4) tend", got.tend,
                ref.tend)]
    for (n, lq, lt) in ((2048, 20, 64), (512, 24 * 31, 800)):   # W = 1, 24
        q, t, ql, tl = planted_pairs(rng, n, lq, lt)
        t[:64, :8] = rng.choice([-1, 4, 9], size=(64, 8))
        ql[:3] = [0, min(31, lq), lq]
        args = to_dev(q, t, ql, tl)
        W = M.n_words(lq)
        got = MC.myers_batch_cuda(*args)
        ref = M.myers_batch(*args)
        errs += [eq(f"K1 W={W} dist", got.dist, ref.dist),
                 eq(f"K1 W={W} tend", got.tend, ref.tend)]
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


def sw_cases(rng, A):
    """K3 checks: the refine's forward and reverse shapes, then edge cases.
    Each case: (label, q, t, qlen, tlen, band)."""
    import numpy as np

    N, Lq, band = 4096, 112, 64
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
    cases = [(f"forward (N {N}, Lq {Lq}, Lt {Lt}) band {band}",
              q, t, ql, tl, band)]
    fwd = A.banded_sw_batch(*to_dev(q, t, ql, tl), band=band)
    rq, rt, rql, rtl = reversed_prefixes(q, t, fwd.qend.cpu().numpy(),
                                         fwd.tend.cpu().numpy())
    cases.append((f"reverse (N {N}, Lq {Lq}, Lt {Lt}) band {2 * band}, "
                  "ragged qend/tend", rq, rt, rql, rtl, 2 * band))
    for n, lq, lt, b, label in ((512, 40, 60, 200, "band >= Lq"),
                                (256, 1024, 1100, 64, "Lq 1024"),
                                (256, 1100, 1200, 64, "Lq 1100"),
                                (64, 1000, 1000, 960,
                                 "band 960 (device scratch)")):
        q, t, ql, tl = planted_pairs(rng, n, lq, lt)
        ql[:2] = [0, lq]
        tl[2:4] = [0, lt]
        q[4, :] = 3
        t[4, :] = 3
        t[5, : lt // 2] = -1
        cases.append((f"{label} (N {n}, Lq {lq}, Lt {lt}) band {b}",
                      q, t, ql, tl, b))
    return cases


def phase_k3(rng, AC, A):
    log("phase 7: K3 banded_sw_batch_cuda vs plain, bit-exact")
    errs = []
    for label, q, t, ql, tl, band in sw_cases(rng, A):
        args = to_dev(q, t, ql, tl)
        got = AC.banded_sw_batch_cuda(*args, band=band)
        ref = A.banded_sw_batch(*args, band=band)
        for f in ("score", "qend", "tend"):
            errs.append(eq(f"K3 {label} {f}", getattr(got, f),
                           getattr(ref, f)))
        if int(ref.score.max()) <= 0:
            fail(f"K3 {label}: no positive score")
    return max(errs)


def kmer_set(seq: str, k: int):
    """Canonical k-mer values (uint64) of a sequence, numpy only."""
    import numpy as np

    from hga_tpu_torch.io.encode import encode_bases

    codes, _ = encode_bases(seq)
    m = len(seq) - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64)
    c = codes.astype(np.uint64)
    fwd = np.zeros(m, np.uint64)
    rc = np.zeros(m, np.uint64)
    for i in range(k):
        fwd |= c[i:i + m] << np.uint64(2 * (k - 1 - i))
        rc |= (np.uint64(3) - c[i:i + m]) << np.uint64(2 * i)
    return np.minimum(fwd, rc)


def evaluate(contigs, genome: str, k: int = 21):
    """k-mer identity (contig k-mers found in the genome) and genome
    fraction (genome k-mers found in the contigs)."""
    import numpy as np

    ref = np.unique(kmer_set(genome, k))
    hit = tot = 0
    sets = []
    for _, s in contigs:
        ck = kmer_set(s, k)
        tot += ck.size
        idx = np.clip(np.searchsorted(ref, ck), 0, ref.size - 1)
        hit += int((ref[idx] == ck).sum())
        sets.append(np.unique(ck))
    cset = np.unique(np.concatenate(sets)) if sets else np.zeros(0, np.uint64)
    idx = np.clip(np.searchsorted(cset, ref), 0, max(cset.size - 1, 0))
    cov = int((cset[idx] == ref).sum()) if cset.size else 0
    lens = sorted((len(s) for _, s in contigs), reverse=True)
    acc, n50 = 0, 0
    for L in lens:
        acc += L
        if 2 * acc >= sum(lens):
            n50 = L
            break
    return dict(n_contigs=len(contigs), n50=n50, total_len=sum(lens),
                identity=hit / tot if tot else 0.0,
                genome_fraction=cov / ref.size if ref.size else 0.0)


_SIMULATED: dict = {}


def simulate(genome_len: int, seed: int):
    """The judged read model (exp/scale_run.py): short 100 bp at 30x, 1%
    error, pad 112; long reads mean 8 kb, min 1 kb, 10% error, 20x.  Made
    once per (genome_len, seed) and shared by the phases."""
    if (genome_len, seed) not in _SIMULATED:
        _SIMULATED[genome_len, seed] = _simulate(genome_len, seed)
    return _SIMULATED[genome_len, seed]


def _simulate(genome_len: int, seed: int):
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.utils import sim

    genome = sim.random_genome(genome_len, seed=seed)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=seed + 1)
    ls, ln = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                     min_len=1000, error_rate=0.10,
                                     seed=seed + 2)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    pr_l = pack_reads(ls, names=ln, category=[1] * len(ls), pad_len=pad_l)
    return genome, pr_s, pr_l


def judged_cfg():
    from hga_tpu_torch.config import AssemblerConfig

    return AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, polish_passes=2,
                           corr_batch_pairs=4096, min_contig_len=2000,
                           arbitrate=False)


def config3_cfg():
    """Judged config 3 (BASELINE.json configs[2]): the judged config with
    the scored SW refine; min_overlap_len 32 because the judged 500 is for
    corrected long reads and no 100 bp read can reach it."""
    return judged_cfg().replace(overlap_refine="sw", min_overlap_len=32)


def short_only_cfg():
    """The short-read-only pipeline: config 3's overlap settings, short
    contigs allowed, copy arbitration left at its default (on: the
    reference arbitrates only with long reads)."""
    return config3_cfg().replace(min_contig_len=300, arbitrate=True)


def phase_pipeline(genome_len: int, MC, workdir: str):
    import torch

    from hga_tpu_torch.models.pipeline import run_pipeline

    log(f"phase 4: run_pipeline(device='cuda') on a {genome_len} bp genome")
    t0 = time.perf_counter()
    genome, pr_s, pr_l = simulate(genome_len, seed=42)
    log(f"  simulated {pr_s.n_reads} short + {pr_l.n_reads} long reads "
        f"in {time.perf_counter() - t0:.1f} s (long pad {pr_l.pad_len})")
    MC.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_pipeline(pr_s, pr_l, judged_cfg(), os.path.join(workdir, "p4"),
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(MC.LAUNCHES)
    log(f"  launches on the main path: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")
    stages = {k: v["seconds"] for k, v in res.stats["stages"].items()}
    ev = evaluate(res.polished, genome)
    out = dict(genome_len=genome_len, n_short=pr_s.n_reads,
               n_long=pr_l.n_reads, pipeline_s=round(wall, 3),
               stage_s=stages, seed_index_s=res.stats.get("seed_index_s"),
               correction_detail=res.stats.get("correction_detail"),
               polish_detail=res.stats.get("polish_detail"),
               overlaps=res.stats.get("overlaps"),
               assembly=res.stats.get("assembly"), eval=ev,
               peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
               launches=launches)
    log("  pipeline: " + json.dumps(out))
    if not res.polished:
        fail("the pipeline produced no contig")
    if ev["identity"] < 0.99:
        fail(f"k-mer identity {ev['identity']:.5f} < 0.99")
    return launches, out


def same_outputs(dirs, text, npz) -> None:
    """Fail unless the cuda and cpu output directories hold byte-identical
    text files and equal arrays."""
    import numpy as np

    for f in text:
        a = open(os.path.join(dirs["cuda"], f), "rb").read()
        b = open(os.path.join(dirs["cpu"], f), "rb").read()
        if a != b:
            fail(f"{f} differs between cuda and cpu")
        log(f"  ok: {f} byte-identical ({len(a)} bytes)")
    for f in npz:
        za = np.load(os.path.join(dirs["cuda"], f))
        zb = np.load(os.path.join(dirs["cpu"], f))
        if sorted(za.files) != sorted(zb.files):
            fail(f"{f}: keys differ")
        for k in za.files:
            if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k]):
                fail(f"{f}[{k}] differs between cuda and cpu")
        log(f"  ok: {f} arrays equal ({len(za.files)} arrays)")


def phase_cpu_equal(workdir: str):
    from hga_tpu_torch.models.overlap import compute_overlaps_cross
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
    same_outputs(dirs, ("contigs.fasta", "assembly.gfa", "polished.fasta"),
                 ("spectrum.npz", "corrected.npz", "overlaps.npz"))

    log("  config 3 (compute_overlaps_cross, refine sw), 8 kb genome")
    _, pr_s, pr_l = simulate(8_000, seed=8)
    dirs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        ov = compute_overlaps_cross(pr_s, pr_l, config3_cfg(), device=dev)
        d = dirs[dev] = os.path.join(workdir, f"p5c3_{dev}")
        os.makedirs(d)
        ov.save(os.path.join(d, "overlaps.npz"))
        with open(os.path.join(d, "overlaps.paf"), "w") as fh:
            fh.write(ov.to_paf(pr_s.names, pr_l.names))
        log(f"  {dev}: {ov.n} overlaps in {time.perf_counter() - t0:.1f} s")
        if ov.n == 0:
            fail(f"config 3 on {dev} found no overlap")
    same_outputs(dirs, ("overlaps.paf",), ("overlaps.npz",))

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


def read_loci(names):
    """Truth loci from simulated read names (utils/sim.py):
    sr_{i}_{start}_{strand} and lr_{i}_{start}_{strand}_{len}."""
    import numpy as np

    f = [n.split("_") for n in names]
    start = np.array([int(x[2]) for x in f], np.int64)
    strand = np.array([int(x[3]) for x in f], np.int64)
    length = np.array([int(x[4]) if len(x) > 4 else 0 for x in f], np.int64)
    return start, strand, length


def phase_config3(genome_len: int, MC, AC):
    """Judged config 3 on the card: short reads of the judged read model
    against its long reads, refine sw; precision against the truth loci."""
    import numpy as np
    import torch

    from hga_tpu_torch.models import overlap as OV

    log(f"phase 8: config 3 (compute_overlaps_cross, refine sw) on a "
        f"{genome_len} bp genome")
    t0 = time.perf_counter()
    _, pr_s, pr_l = simulate(genome_len, seed=42)
    log(f"  {pr_s.n_reads} short + {pr_l.n_reads} long reads "
        f"({time.perf_counter() - t0:.1f} s to simulate or reuse)")
    MC.reset_launches()
    AC.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = OV.compute_overlaps_cross(pr_s, pr_l, config3_cfg(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(MC.LAUNCHES, **AC.LAUNCHES)
    for name in ("myers_batch_cuda", "banded_sw_batch_cuda"):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the config-3 path")
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
    out = dict(genome_len=genome_len, n_short=pr_s.n_reads,
               n_long=pr_l.n_reads, candidates=t["gate_pairs"],
               survivors=t["refine_pairs"], records=rec.n,
               gate_s=t["gate_s"], refine_s=t["refine_s"],
               overlaps_s=round(wall, 3),
               precision=round(float((inside & strands).mean()), 6),
               precision_touching=round(float((touching & strands).mean()),
                                        6),
               peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
               launches=launches)
    log("  config 3: " + json.dumps(out))
    if out["precision"] < 0.95:
        fail(f"config-3 precision {out['precision']} < 0.95: records must "
             "pair a short read inside its long read's locus, rel = the "
             "strands' xor")
    return launches, out


def cuda_ms(fn, arg_sets, reps: int) -> float:
    """Mean ms per call over `reps` calls cycling through distinct inputs,
    after one warm-up call per input set (CUDA events)."""
    import torch

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for r in range(reps):
        fn(*arg_sets[r % len(arg_sets)])
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def phase_times(rng, MC, M, PU):
    import torch

    from hga_tpu_torch.models import correction as CR

    log("phase 6: kernel times (CUDA events, distinct inputs, warm)")
    rows = {}
    for name, planes, (N, Lq, Lt) in (
            ("myers_batch_cuda", False, (4096, 414, 478)),
            ("myers_batch_planes_cuda", True, (4096, 112, 184))):
        W = M.n_words(Lq)
        sets = [to_dev(*planted_pairs(rng, N, Lq, Lt)) for _ in range(4)]
        wrapper = MC.myers_batch_planes_cuda if planes else MC.myers_batch_cuda
        plain = M.myers_batch_planes if planes else M.myers_batch
        ops = [MC.kernel_operands(*a, planes=planes) for a in sets]
        n_before = dict(MC.LAUNCHES)
        ms = cuda_ms(wrapper, sets, 20)
        kern_ms = cuda_ms(MC.run_kernel, ops, 20)
        plain_ms = cuda_ms(plain, sets[:1], 1)
        MC.LAUNCHES.update(n_before)     # timing launches are not main path
        cells = N * Lq * Lt
        in_bytes = 4 * N * (Lq + Lt) + 8 * N
        out_bytes = 8 * N + (2 * 4 * Lt * N * W if planes else 0)
        byte_ms = 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S
        op_ms = 1e3 * N * Lt * W * OPS_PER_WORD_COLUMN / INT32_OPS_PER_S
        regs, local = MC.kernel_attrs(W, planes)
        rows[name] = dict(
            shape=dict(N=N, Lq=Lq, Lt=Lt, W=W), ms=round(ms, 4),
            kernel_ms=round(kern_ms, 4), plain_ms=round(plain_ms, 3),
            gcups=round(cells / (ms * 1e-3) / 1e9, 2),
            kernel_gcups=round(cells / (kern_ms * 1e-3) / 1e9, 2),
            bound_ms=round(max(byte_ms, op_ms), 5),
            bound_by="bytes" if byte_ms > op_ms else "operations",
            registers=regs, local_bytes=local,
            blocks=-(-N // 128))
        log(f"  {name}: {json.dumps(rows[name])}")

    # one correction batch at the judged shape: K2 + gate / traceback split
    N, Lq, Lt = 4096, 112, 184
    q, t, ql, tl = to_dev(*planted_pairs(rng, N, Lq, Lt))
    nb, lpad = 64, 8192
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * 3 * 4
    merged = torch.zeros(size_all + 1, dtype=torch.int32, device="cuda")
    bb = torch.from_numpy(rng.integers(0, nb, N).astype("int32")).cuda()
    off = torch.from_numpy(rng.integers(0, lpad - Lt, N).astype("int32")).cuda()
    lb = torch.full((N,), lpad, dtype=torch.int32, device="cuda")
    n_before = dict(MC.LAUNCHES)
    steps = Lq + int(0.25 * Lq) + 2
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    planes_ms = tb_ms = 0.0
    reps = 6
    for r in range(reps + 1):            # the first pass warms up
        ev[0].record()
        res, pv, mv = CR._planes_inner(q, t, ql, tl)
        max_ed = (0.25 * ql.float()).to(torch.int32)
        qend = torch.where((res.dist <= max_ed) & (res.tend > 0), ql, 0)
        ev[1].record()
        PU.accumulate_backbone_votes_myers(
            merged, pv, mv, res.dist, qend, res.tend, q, t, bb, off, lb,
            size_v=size_v, lpad=lpad, ins_slots=3, max_steps=steps)
        ev[2].record()
        torch.cuda.synchronize()
        if r:
            planes_ms += ev[0].elapsed_time(ev[1]) / reps
            tb_ms += ev[1].elapsed_time(ev[2]) / reps
    MC.LAUNCHES.update(n_before)
    split = dict(planes_gate_ms=round(planes_ms, 3),
                 traceback_ms=round(tb_ms, 3),
                 batch_ms=round(planes_ms + tb_ms, 3),
                 traceback_share=round(tb_ms / (planes_ms + tb_ms), 4))
    log(f"  correction batch (N 4096, Lq 112, Lt 184): {json.dumps(split)}")
    return rows, split


def phase_times_k3(rng, AC, A):
    """K3 at the refine's shapes: kernel alone and wrapper (CUDA events,
    distinct inputs), the plain version, GCUPS on in-band cells, bound."""
    log("phase 6: K3 times (CUDA events, distinct inputs, warm)")
    N, Lq, band = 4096, 112, 64
    Lt = Lq + band + 8
    fwd_sets = [planted_pairs(rng, N, Lq, Lt, lead=band // 2)
                for _ in range(4)]
    rev_sets = []
    for q, t, ql, tl in fwd_sets:
        r = A.banded_sw_batch(*to_dev(q, t, ql, tl), band=band)
        rev_sets.append(reversed_prefixes(q, t, r.qend.cpu().numpy(),
                                          r.tend.cpu().numpy()))
    rows = {}
    for shape, sets, b in (("forward", fwd_sets, band),
                           ("reverse", rev_sets, 2 * band)):
        dev_sets = [to_dev(*x) for x in sets]
        wrapper = lambda *x: AC.banded_sw_batch_cuda(*x, band=b)
        plain = lambda *x: A.banded_sw_batch(*x, band=b)
        ops = [AC.kernel_operands(*x, band=b) for x in dev_sets]
        n_before = dict(AC.LAUNCHES)
        ms = cuda_ms(wrapper, dev_sets, 20)
        kern_ms = cuda_ms(AC.run_kernel, ops, 20)
        plain_ms = cuda_ms(plain, dev_sets[:1], 1)
        AC.LAUNCHES.update(n_before)     # timing launches are not main path
        cells = sum(A.sw_cells(x[2], x[3], b) for x in sets) / len(sets)
        in_bytes = 4 * N * (Lq + Lt) + 8 * N
        byte_ms = 1e3 * (in_bytes + 12 * N) / HBM_BYTES_PER_S
        op_ms = 1e3 * cells * SW_OPS_PER_CELL / INT32_OPS_PER_S
        rows[shape] = dict(
            shape=dict(N=N, Lq=Lq, Lt=Lt, band=b), cells=int(cells),
            ms=round(ms, 4), kernel_ms=round(kern_ms, 4),
            plain_ms=round(plain_ms, 3),
            gcups=round(cells / (ms * 1e-3) / 1e9, 2),
            kernel_gcups=round(cells / (kern_ms * 1e-3) / 1e9, 2),
            bound_ms=round(max(byte_ms, op_ms), 5),
            bound_by="bytes" if byte_ms > op_ms else "operations")
        log(f"  banded_sw_batch_cuda {shape}: {json.dumps(rows[shape])}")
    regs, local = AC.kernel_attrs(smem=True)
    rows["forward"].update(registers=regs, local_bytes=local,
                           blocks=-(-N // AC.THREADS))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-len", type=int, default=1_000_000,
                    help="phase-4 genome length (default 1,000,000 bp)")
    ap.add_argument("--phases", default="012345678",
                    help="phases to run (default all)")
    args = ap.parse_args()

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
    from hga_tpu_torch.ops import align as A
    from hga_tpu_torch.ops import align_cuda as AC
    from hga_tpu_torch.ops import cuda_build
    from hga_tpu_torch.ops import myers as M
    from hga_tpu_torch.ops import myers_cuda as MC
    from hga_tpu_torch.ops import pileup as PU

    ph = set(args.phases)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all(force=True)
    built = {n: dict(cuda_build.BUILD_INFO[n]) for n in libs}
    MC._lib()
    AC._lib()
    log(f"phase 1: built {len(libs)} libraries (one nvcc each, in parallel) "
        f"in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{os.path.relpath(p, HERE)} {built[n]['seconds']:.1f} s"
            for n, p in libs.items()))
    report = ptxas_report("".join(str(b["ptxas"]) for b in built.values()))
    log(f"  ptxas report: {len(report)} of {2 * M.MAX_WORDS + 2} kernel "
        "instantiations parsed")
    for kern in ("K1", "K2", "K3"):
        rows = [r for r in report if r[0] == kern]
        log(f"  ptxas {kern} registers by {'buffer' if kern == 'K3' else 'W'}: "
            + " ".join(f"{w}:{regs}" for _, w, regs, _ in rows))
        log(f"  ptxas {kern} spill stores/loads (bytes) where nonzero: "
            + (" ".join(f"{w}:{s[0]}/{s[1]}" for _, w, _, s in rows if any(s))
               or "none"))

    rng = np.random.default_rng(7)
    err = dict.fromkeys(SOURCES)     # None: the kernel's check did not run
    if "2" in ph:
        err["myers_batch_cuda"] = phase_k1(rng, MC, M)
    if "3" in ph:
        err["myers_batch_planes_cuda"] = phase_k2(rng, MC, M, PU)
    if "7" in ph:
        err["banded_sw_batch_cuda"] = phase_k3(rng, AC, A)
    torch.cuda.synchronize()

    # launches per kernel on each main path that ran: K1 and K2 on the
    # hybrid pipeline (phase 4), K1 and K3 on config 3 (phase 8)
    workdir = tempfile.mkdtemp(prefix="hga_smoke_")
    paths = {}
    try:
        if "4" in ph:
            paths["phase 4 hybrid pipeline"], _ = phase_pipeline(
                args.genome_len, MC, workdir)
        if "8" in ph:
            paths["phase 8 config 3"], _ = phase_config3(args.genome_len,
                                                         MC, AC)
        if "5" in ph:
            phase_cpu_equal(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    if "6" in ph:
        rows, split = phase_times(rng, MC, M, PU)
        sw = phase_times_k3(rng, AC, A)
        rows["banded_sw_batch_cuda"] = dict(sw["forward"],
                                            reverse=sw["reverse"])
        for name, r in rows.items():
            # null where the phase that measures a number did not run
            by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
            kernels.append(dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name],
                launches=sum(by_path.values()) if by_path else None,
                launches_by_path=by_path,
                max_abs_err=err[name], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None, kernel_ms=r["kernel_ms"], gcups=r["gcups"],
                matches_plain=None if err[name] is None else err[name] == 0,
                shape=r["shape"],
                registers=r["registers"], local_bytes=r["local_bytes"],
                **({"reverse": r["reverse"]} if "reverse" in r else {})))
        log("  no single PyTorch call computes Myers edit distance or "
            "banded local SW: library_ms is null")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
