#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (hga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, 1 Mb genome
    python3 chip_smoke.py --genome-len 4600000

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. card facts: nvidia-smi name/power limit, torch and CUDA versions
  1. build the CUDA kernels from hga_tpu_torch/csrc (one nvcc per source,
     in parallel, sm_90a), timed; registers/spills per instantiation
  2. K1' (myers_batch_cuda) == its plain PyTorch version, bit-exact, through
     the wrapper and in the other design (G 1 or group_width(W)), at the
     long-overlap shape (N 4096, Lq 414, Lt 478), the config-3 gate shape
     (N 4096, Lq 112, Lt 184, ragged, code-4 padding) and at W 1, 2, 4, 5,
     14, 16, 24 with qlen 0, 1, 31, 32, 62, Lq - 1, ragged tlen and codes
     -1, 4, 9
  3. K2 (myers_batch_planes_cuda) == its plain version (dist, tend, Pv, Mv)
     at the correction shape (N 4096, Lq 112, Lt 184), and the traceback
     votes made from each set of planes are equal
  4. the port's main path, run_pipeline(device="cuda"), on a simulated
     genome with the judged read model; K1' and K2's launch counters must
     move; per-stage seconds, contigs, N50, k-mer identity (>= 0.99) and
     genome fraction
  5. the same pipeline on a ~20 kb genome on cuda and on cpu: artifacts
     byte-identical / array-equal
  6. CUDA-event times of each kernel (wrapper and kernel alone) and of its
     plain version, GCUPS, bounds and the share of them, registers: K1' in
     both designs at W 14, 4, 5 and 1, K2, K3' at the refine's shapes
     beside K3's kernel on the same inputs, K3 at Lq 320; and the
     correction batch split (K2 + gate / traceback)
  7. banded_sw_batch_cuda == its plain version, bit-exact, every case
     through the wrapper, whose route counter must move: K3' at the
     refine's forward (N 4096, Lq 112, Lt 184, band 64) and reverse (band
     128, ragged) shapes and at Lq 1, 31, 32, 33, 112, 128, 129, 256 at
     bands 0, 64, 128, >= Lq; K3 (rows) at Lq 257, 1024, 1100 and band 960
     (device scratch); tie rows, -1 and 4 codes, qlen/tlen 0 everywhere
  8. judged config 3, compute_overlaps_cross(device="cuda") with the SW
     refine, on the phase-4 reads: K1' and K3' counters must move, K3's
     stay 0, truth precision >= 0.95; then 300 bp reads on a 100 kb genome,
     whose refine width takes K3's row route (K3' stays 0)
  9. the measurement path: X1 (exp/myers_micro run_b), X2 (exp/sw_variants
     v1, v2, v3) and X3 (exp/vpu_micro) == their plain versions, bit-exact;
     then the three harnesses' main() as a user runs them (their counters
     must move), the SASS add/max count of X3 and the DPX instructions of
     X2, and `hga-torch bench --what sw|myers|count|pipeline --pairs 8192`
     through cli.main (the K1' and K3' counters must move)

Phase 5 also runs config 3 and the short-read-only pipeline (8 kb genome)
on cuda and on cpu, byte-identical.  Phases run in the order
0 1 2 3 7 4 8 5 6 9.

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
    "myers_batch_planes_cuda": ("hga_tpu_torch/csrc/myers.cu",
                                "hga_tpu/ops/myers_pallas.py:106"),
    "banded_sw_batch_cuda": ("hga_tpu_torch/csrc/sw.cu",
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
    ("K3'", r"sw_diag_kernelILi(\d+)E", lambda g: f"K{g[0]}"),
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
    lanes a pair, K2 by W, K3' by slots a lane, K3 by buffer kind, X1 by W,
    X2 by layout, K, G and ablation flags, X3 by C and STEPS."""
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


def sw_cases(rng, A):
    """K3' and K3 checks: the refine's forward and reverse shapes, band >=
    Lq, the row route's shapes (Lq 1024 and 1100, band 960 with the device
    scratch), then K3' at every slot count's edges (Lq 1 .. 256, and 257,
    which takes the row route) at bands 0, 64, 128 and >= Lq.  Each case:
    (label, q, t, qlen, tlen, band)."""
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
        cases.append((f"{label} (N {n}, Lq {lq}, Lt {lt}) band {b}",
                      *sw_edges(rng, n, lq, lt, b), b))
    for lq in (1, 31, 32, 33, 112, 128, 129, 256, 257):
        lt = lq + 72
        for b in (0, 64, 128, lq + 7):
            cases.append((f"Lq {lq} (N 512, Lt {lt}) band {b}",
                          *sw_edges(rng, 512, lq, lt, b), b))
    return cases


def phase_k3(rng, AC, A):
    """Every case through the wrapper, which picks the route by shape: the
    route's counter must move; K3' and K3 are reported apart."""
    log("phase 7: K3' and K3 banded_sw_batch_cuda vs plain, bit-exact")
    errs = {"banded_sw_batch_cuda": [], "banded_sw_batch_cuda_rows": []}
    for label, q, t, ql, tl, band in sw_cases(rng, A):
        args = to_dev(q, t, ql, tl)
        r = AC.route(q.shape[1], t.shape[1], band)
        key = AC.ROUTE_COUNTER[r.kind]
        before = AC.LAUNCHES[key]
        got = AC.banded_sw_batch_cuda(*args, band=band)
        if AC.LAUNCHES[key] != before + 1:
            fail(f"K3 {label}: the {r.kind} route was not launched")
        ref = A.banded_sw_batch(*args, band=band)
        name = "K3'" if r.kind == "diag" else "K3 (rows)"
        for f in ("score", "qend", "tend"):
            errs[key].append(eq(f"{name} {label} {f}", getattr(got, f),
                                getattr(ref, f)))
        if int(ref.score.max()) <= 0:
            fail(f"K3 {label}: no positive score")
    return {k: max(v) for k, v in errs.items()}


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
# phase 8's second drive: 300 bp short reads (Illumina MiSeq 2 x 300), whose
# refine width (pad 320) takes K3's row route, on a 100 kb genome
MISEQ_GENOME = 100_000


def simulate(genome_len: int, seed: int, read_len: int = 100):
    """The judged read model (exp/scale_run.py): short 100 bp at 30x, 1%
    error, pad 112; long reads mean 8 kb, min 1 kb, 10% error, 20x.  Made
    once per (genome_len, seed, read_len) and shared by the phases;
    `read_len` 300 (Illumina MiSeq's 2 x 300 reads) pads to 320."""
    key = (genome_len, seed, read_len)
    if key not in _SIMULATED:
        _SIMULATED[key] = _simulate(*key)
    return _SIMULATED[key]


def _simulate(genome_len: int, seed: int, read_len: int):
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.utils import sim

    genome = sim.random_genome(genome_len, seed=seed)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0,
                                      read_len=read_len, error_rate=0.01,
                                      seed=seed + 1)
    ls, ln = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                     min_len=1000, error_rate=0.10,
                                     seed=seed + 2)
    pad_s = 112 if read_len == 100 else -(-(read_len + 12) // 32) * 32
    pr_s = pack_reads(ss, names=sn, pad_len=pad_s)
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


def phase_config3(genome_len: int, MC, AC, read_len: int = 100,
                  seed: int = 42):
    """Judged config 3 on the card: short reads of the judged read model
    against its long reads, refine sw; precision against the truth loci.
    The refine's width (the short reads' pad) picks the SW route: K3' at
    100 bp reads (pad 112), K3 at 300 bp reads (pad 320); the other route's
    counter must stay at 0.  The 100 bp drive counts a record right when
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


def phase_times(rng, MC, M, PU):
    import torch

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
    for name, r in rows.items():
        log(f"  {name}: {json.dumps(r)}")

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


def sw_row(AC, A, sets, band, rows_route):
    """One SW timing row: the wrapper and the kernel alone of the route the
    shape takes (K3 when `rows_route`), GCUPS on in-band cells, bound."""
    import numpy as np

    from hga_tpu_torch.utils import benchmarks as B

    N, Lq = sets[0][0].shape
    Lt = sets[0][1].shape[1]
    dev_sets = [to_dev(*x) for x in sets]
    cells = sum(A.sw_cells(x[2], x[3], band) for x in sets) / len(sets)
    r = AC.rows_route(Lq, Lt, band) if rows_route else AC.route(Lq, Lt,
                                                                  band)
    row = time_row(
        dict(N=N, Lq=Lq, Lt=Lt, band=band, route=r.kind),
        lambda *x: AC.banded_sw_batch_cuda(*x, band=band), dev_sets,
        AC.run_kernel,
        [AC.kernel_operands(*x, band=band, rows=rows_route)
         for x in dev_sets],
        lambda *x: A.banded_sw_batch(*x, band=band), cells,
        cells * B.SW_OPS_PER_CELL, 4 * N * (Lq + Lt) + 8 * N + 12 * N,
        [AC.LAUNCHES])
    row.update(zip(("registers", "local_bytes"), AC.kernel_attrs(r)),
               K=r.K, warps=r.warps, smem=r.smem)
    row["blocks"] = -(-N // r.warps) if r.kind == "diag" else \
        -(-N // AC.THREADS)
    if r.kind == "diag":
        # slot-steps the warps sweep (32 K per anti-diagonal up to each
        # pair's last in-band one) and the share of them in band
        ql = np.clip(np.concatenate([x[2] for x in sets]), 0, Lq)
        tl = np.minimum(np.concatenate([x[3] for x in sets]), Lt)
        dend = np.where(ql >= 1, ql + np.minimum(tl, ql + band), 1)
        swept = 32 * r.K * (dend - 1).clip(min=0).sum() / len(sets)
        row["in_band_share"] = cells / swept
    if not rows_route and r.kind == "diag":
        # the wrapper's own route only: kernel alone of K3 at this shape
        row["rows_kernel_ms"] = B.cuda_ms(
            AC.run_kernel, [AC.kernel_operands(*x, band=band, rows=True)
                            for x in dev_sets], 20, passes=3)
    return row


def phase_times_k3(rng, AC, A):
    """K3' at the refine's shapes (Lq 112: forward band 64, reverse band
    128) beside K3's kernel at the same inputs, and K3 at the shapes that
    take its route (300 bp reads: Lq 320)."""
    log("phase 6: K3' and K3 times (CUDA events, distinct inputs, warm)")
    rows = {}
    for key, Lq in (("banded_sw_batch_cuda", 112),
                    ("banded_sw_batch_cuda_rows", 320)):
        passes, Lt = refine_sets(rng, A, 4096, Lq, 64)
        r = {shape: sw_row(AC, A, sets, b, key.endswith("rows"))
             for shape, sets, b in passes}
        rows[key] = dict(r["forward"], reverse=r["reverse"])
        for shape, row in r.items():
            log(f"  {key} {shape}: {json.dumps(row)}")
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
              *SV.planted_inputs(256, 128, 256), 64)] + sw_cases(rng, A)[:3]
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
                    help="phase-4 genome length (default 1,000,000 bp)")
    ap.add_argument("--phases", default="0123456789",
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
    log(f"phase 1: built {len(libs)} libraries (one nvcc each, in parallel) "
        f"in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{os.path.relpath(p, HERE)} {built[n]['seconds']:.1f} s"
            for n, p in libs.items()))
    report = ptxas_report("".join(str(b["ptxas"]) for b in built.values()))
    expect = ((2 * M.MAX_WORDS - 1) + M.MAX_WORDS + len(AC.DIAG_SLOTS) + 2
              + M.MAX_WORDS + sum(len(k) for k in SV.BUILT.values())
              + len(VM.BUILT))
    log(f"  ptxas report: {len(report)} of {expect} kernel instantiations "
        "parsed")
    for kern, by in (("K1'", "W, lanes a pair"), ("K2", "W"),
                     ("K3'", "slots a lane"), ("K3", "buffer"), ("X1", "W"),
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
        done("2")
    if "3" in ph:
        err["myers_batch_planes_cuda"] = phase_k2(rng, MC, M, PU)
        done("3")
    if "7" in ph:
        err.update(phase_k3(rng, AC, A))
        done("7")
    torch.cuda.synchronize()

    # launches per kernel on each path that ran: K1' and K2 on the hybrid
    # pipeline (phase 4), K1' and K3' on config 3 and K1' and K3 on its
    # 300 bp drive (phase 8), X1-X3 on the harnesses and K1'/K3' on
    # hga-torch bench (phase 9)
    workdir = tempfile.mkdtemp(prefix="hga_smoke_")
    paths = {}
    try:
        if "4" in ph:
            paths["phase 4 hybrid pipeline"], _ = phase_pipeline(
                args.genome_len, MC, workdir)
            done("4")
        if "8" in ph:
            paths["phase 8 config 3"], _ = phase_config3(args.genome_len,
                                                         MC, AC)
            paths["phase 8 config 3, 300 bp reads"], _ = phase_config3(
                MISEQ_GENOME, MC, AC, read_len=300, seed=44)
            done("8")
        if "5" in ph:
            phase_cpu_equal(workdir)
            done("5")
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
        rows, split = phase_times(rng, MC, M, PU)
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
        e.update(launches=sum(by_path.values()) if by_path else None,
                 launches_by_path=by_path, max_abs_err=err[name],
                 matches_plain=None if err[name] is None else err[name] == 0)
    log("  no single PyTorch call computes Myers edit distance, banded "
        "local SW or the add/max chains: library_ms is null")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
