"""Judged-scale run: the hybrid pipeline (judged configs 1-5) on a simulated
E. coli-sized genome, 4.6 Mb by default, with 30x short and 20x long reads.

Counterpart of exp/scale_run.py.  The genome is seeded random
(``sim.random_genome``, seed 42) or, with ``--repeats``, the repeat-bearing
model (``sim.repeat_genome``: 7 ~5 kb rRNA operons at 99%, IS-element
families, tandem repeats); ``--circular`` samples reads across the origin
of a circular chromosome, and the contigs are then judged as a circle.
``simulate`` holds the read model and ``judged_cfg`` the judged config;
``chip_smoke.py`` takes both from here.

It writes ``scale_metrics.json`` into the run directory with the JAX
script's keys: stage seconds, reads/s, the evaluation, the correction,
polish, arbitration and overlap splits from the pipeline's stats, and
``split_reconciliation`` (a WARNING line when a stage's split sums to more
than about twice its seconds).  The split dicts are the port's
``LAST_TIMINGS`` under the reference's names.  Two of them hold a value
that is fixed in the port, kept for the key: ``dev_prep`` is always true
(batch prep always runs on the device) and ``bytes_up`` counts the four
int32 id vectors a correction batch ships.  ``drain_s`` is the final
``torch.cuda.synchronize`` of the vote loop.

    python -m hga_tpu_torch.exp.scale_run [genome_mb] [outdir] [--repeats]
        [--circular] [--corr-passes=N] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from hga_tpu_torch.exp.common import positional, split_device, sync, tmp_path

# stage -> (its split in scale_metrics.json, the split's timed components)
RECONCILED = (
    ("corrected", "correction_split",
     ("index_s", "gcand_s", "cand_s", "loop_s", "shared_index_s")),
    ("polish", "polish_split", ("cand_s", "loop_s")),
    ("arbitrate", "arbitrate_split", ("place_s", "mat_s", "vote_s")),
    ("overlaps", "overlap_split",
     ("index_s", "anchor_s", "chain_s", "segprep_s", "dp_s")),
)


def simulate_reads(genome_len: int, seed: int = 42, read_len: int = 100,
                   repeats: bool = False, circular: bool = False):
    """The judged read model: short reads `read_len` bp at 30x with 1%
    error (seed + 1), long reads mean 8 kb, min 1 kb, 10% error at 20x
    (seed + 2) on a genome of `seed`.  Returns (genome, (short seqs,
    names), (long seqs, names))."""
    from hga_tpu_torch.utils import sim

    genome = (sim.repeat_genome(genome_len, seed=seed) if repeats
              else sim.random_genome(genome_len, seed=seed))
    # --circular: E. coli's chromosome is a circle; origin-spanning reads
    # close the string graph into a cycle and the assembler emits one
    # *_circular contig (models/assembly.py)
    short = sim.simulate_short_reads(genome, coverage=30.0,
                                     read_len=read_len, error_rate=0.01,
                                     seed=seed + 1, circular=circular)
    long_ = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                    min_len=1000, error_rate=0.10,
                                    seed=seed + 2, circular=circular)
    return genome, short, long_


def pack(short, long_, read_len: int = 100):
    """Pack the reads: short pad 112 for 100 bp reads (else read_len + 12
    rounded up to 32), long pad the longest read rounded up to 32."""
    from hga_tpu_torch.io.encode import pack_reads

    (ss, sn), (ls, ln) = short, long_
    pad_s = 112 if read_len == 100 else -(-(read_len + 12) // 32) * 32
    pr_s = pack_reads(ss, names=sn, pad_len=pad_s)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    pr_l = pack_reads(ls, names=ln, category=[1] * len(ls), pad_len=pad_l)
    return pr_s, pr_l


def simulate(genome_len: int, seed: int = 42, read_len: int = 100,
             repeats: bool = False, circular: bool = False):
    """simulate_reads, then pack: (genome, short PackedReads, long
    PackedReads)."""
    genome, short, long_ = simulate_reads(genome_len, seed, read_len,
                                          repeats, circular)
    return (genome, *pack(short, long_, read_len))


def judged_cfg(corr_passes: int = 1):
    """The judged config.  k = 15 / w = 5 seeding: a 10%-error long read
    keeps ~0.9^15 = 21% of its k-mers exact, where k = 21 (11%) starves
    the correction anchors; the judged k = 21 spectrum stays `count`'s
    default.  corr_depth_cap stays 0: the pipeline derives ~0.7x the base
    coverage from the spectrum peak."""
    from hga_tpu_torch.config import AssemblerConfig

    return AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, polish_passes=2,
                           corr_passes=corr_passes,
                           corr_batch_pairs=4096, min_contig_len=2000)


def run(pr_s, pr_l, cfg, outdir: str, device="cuda"):
    """run_pipeline(..., resume=True) on `device`, as the JAX script calls
    it; returns (PipelineResult, seconds), the clock read after the card
    has finished."""
    from hga_tpu_torch.models.pipeline import run_pipeline
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    res = run_pipeline(pr_s, pr_l, cfg, outdir, resume=True, device=dev)
    sync(dev)
    return res, time.perf_counter() - t0


def reconcile(stages: Dict, splits: Dict) -> Tuple[Dict, List[str]]:
    """Each stage's split components against the stage's seconds (at least
    ~half accounted; the remainder is untimed glue): ({stage: {stage_s,
    split_sum_s}}, the WARNING lines)."""
    recon, warnings = {}, []
    for name, key, parts in RECONCILED:
        split = splits[key]
        if name in stages and split:
            acc = sum(split.get(k, 0) for k in parts)
            recon[name] = dict(stage_s=stages[name]["seconds"],
                               split_sum_s=round(acc, 1))
            if acc > 0 and not (0.5 * acc <= stages[name]["seconds"] * 1.05):
                warnings.append(
                    f"WARNING: {name} split {acc:.0f}s does not reconcile "
                    f"with stage {stages[name]['seconds']:.0f}s")
    return recon, warnings


def scale_metrics(res, genome: str, pr_s, pr_l, t_pipe: float,
                  gmb: float, repeats: bool, circular: bool
                  ) -> Tuple[Dict, List[str]]:
    """scale_metrics.json's object and the reconciliation's WARNING lines."""
    from hga_tpu_torch.utils.evalx import evaluate_contigs

    total_reads = pr_s.n_reads + pr_l.n_reads
    ev = evaluate_contigs(res.polished, genome, k=21, circular=circular)
    ev["circular_contigs"] = sum(
        1 for n, _ in res.polished if n.endswith("_circular"))
    # per-stage splits from the pipeline stats captured at each stage
    stats = res.stats
    stages = stats["stages"]
    splits = dict(
        # the shared short-read seed index is built inside whichever stage
        # first needs it (correction): it is accounted there
        correction_split=dict(stats.get("correction_detail", {}),
                              shared_index_s=stats.get("seed_index_s", 0)),
        polish_split=stats.get("polish_detail", {}),
        arbitrate_split=stats.get("arbitrate_detail", {}),
        overlap_split={k: v for k, v in stats.get("overlaps", {}).items()
                       if k != "n"})
    recon, warnings = reconcile(stages, splits)
    out = dict(genome_mb=gmb, repeats=repeats, circular=circular,
               n_short=pr_s.n_reads, n_long=pr_l.n_reads,
               pipeline_seconds=round(t_pipe, 1),
               reads_per_s=round(total_reads / t_pipe, 1),
               stages=stages, eval=ev, **splits,
               split_reconciliation=recon,
               assembly=stats.get("assembly", {}),
               derived=stats.get("derived", {}))
    return out, warnings


def main(argv: Optional[List[str]] = None) -> Dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    flags, device = split_device(argv)
    args = positional(flags)
    repeats = "--repeats" in flags
    circular = "--circular" in flags
    gmb = float(args[0]) if len(args) > 0 else 4.6
    outdir = args[1] if len(args) > 1 else tmp_path(
        f"scale_{gmb}mb" + ("_rep" if repeats else "")
        + ("_circ" if circular else ""))
    G = int(gmb * 1_000_000)
    corr_passes = 1
    for a in flags:
        if a.startswith("--corr-passes="):
            corr_passes = int(a.split("=")[1])
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)

    t0 = time.perf_counter()
    genome, short, long_ = simulate_reads(G, 42, repeats=repeats,
                                          circular=circular)
    t_sim = time.perf_counter() - t0
    print(f"sim: {len(short[0])} short + {len(long_[0])} long reads in "
          f"{t_sim:.0f}s (repeats={repeats}, circular={circular})",
          flush=True)
    t0 = time.perf_counter()
    pr_s, pr_l = pack(short, long_)
    t_pack = time.perf_counter() - t0
    print(f"pack: {t_pack:.0f}s (long pad {pr_l.pad_len})", flush=True)
    del short, long_

    res, t_pipe = run(pr_s, pr_l, judged_cfg(corr_passes), outdir,
                      device=dev)
    out, warnings = scale_metrics(res, genome, pr_s, pr_l, t_pipe, gmb,
                                  repeats, circular)
    for w in warnings:
        print(w, flush=True)
    print(json.dumps(out, indent=2), flush=True)
    with open(os.path.join(outdir, "scale_metrics.json"), "w") as fh:
        json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
