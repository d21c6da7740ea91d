"""The ``hga-torch`` command line: the port's counterpart of ``hga``.

Subcommands, with the reference's flags and ``--config`` JSON, plus
``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions):

  count     — config 1: k-mer counting + spectrum histogram
  seeds     — config 2: minimizer seeding + candidate pair detection
  overlap   — config 3: overlaps (PAF out); short reads against long reads
              when both are given, else all-vs-all of one read set
  assemble  — config 4: with --overlaps only the graph + unitig stage,
              otherwise the full pipeline
  pipeline  — config 5: the full hybrid pipeline
  correct   — config 5a alone: hybrid long-read correction
  eval      — contig identity / N50 vs a reference genome (utils/evalx)
  simulate  — synthetic genome + hybrid read set generator
  bench     — one JSON line of GCUPS (``--what sw`` K3, ``myers`` K1) or
              reads/s (``count``, ``pipeline``) on the device, with the
              H100's roofline, both correction engines' aln/s
              (``correction``), counting over the ranks (``scaling``) or
              the comm volume model (``comm``) (utils/benchmarks.py)

Under ``torchrun --nproc-per-node N -m hga_tpu_torch.cli ...`` every rank
joins the world before any stage (parallel/mesh.init_distributed: NCCL
when each rank has a card of its own, else gloo), ``pipeline`` runs on the
mesh of ranks, the stages split their host loops over the ranks, and
``eval --segs`` sweeps through the ring engine.

``overlap_refine="sw"`` (the scored Smith-Waterman refine) is set through
``--config``, as in the reference.  ``--profile DIR`` on any subcommand
writes a torch.profiler Chrome trace of the command to ``DIR/trace.json``
(CPU activity, and the card's kernels when ``--device`` is ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

from hga_tpu_torch.config import AssemblerConfig

log = logging.getLogger(__name__)


def _add_profile(p: argparse.ArgumentParser) -> None:
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-o", "--outdir", default="hga_out")
    p.add_argument("-k", type=int, default=None)
    p.add_argument("-w", type=int, default=None)
    p.add_argument("--band", type=int, default=None)
    p.add_argument("--batch-reads", type=int, default=None)
    p.add_argument("--max-seed-freq", type=int, default=None)
    p.add_argument("--min-shared", type=int, default=None)
    p.add_argument("--min-overlap-len", type=int, default=None)
    p.add_argument("--min-overlap-score", type=int, default=None)
    p.add_argument("--solid-threshold", type=int, default=None)
    p.add_argument("--corr-engine", choices=["myers", "sw"], default=None,
                   help="correction DP engine (default myers)")
    p.add_argument("--corr-passes", type=int, default=None,
                   help="correction passes (pass n restores up to 3n-base "
                        "deletion runs; default 1)")
    p.add_argument("--polish-passes", type=int, default=None,
                   help="contig polish passes (2 recommended; default 1)")
    p.add_argument("--graph-min-identity", type=float, default=None,
                   help="drop overlaps below this identity before graph "
                        "build (default -1 = auto-fit the bimodal valley, "
                        "0 = off)")
    p.add_argument("--use-quality", action="store_true", default=None,
                   help="quality-weighted consensus votes (FASTQ input)")
    p.add_argument("--no-arbitrate", action="store_true", default=None,
                   help="disable the copy-arbitration stage")
    p.add_argument("--arb-min-depth", type=int, default=None,
                   help="depth floor for arbitration columns (default 5)")
    p.add_argument("--config", help="JSON config file (overridden by flags)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    _add_profile(p)
    p.add_argument("-v", "--verbose", action="store_true")


_FLAGS = [("k", "k"), ("w", "w"), ("band", "band"),
          ("batch_reads", "batch_reads"), ("max_seed_freq", "max_seed_freq"),
          ("min_shared", "min_shared_minimizers"),
          ("min_overlap_len", "min_overlap_len"),
          ("min_overlap_score", "min_overlap_score"),
          ("solid_threshold", "solid_threshold"),
          ("corr_engine", "corr_engine"), ("corr_passes", "corr_passes"),
          ("polish_passes", "polish_passes"),
          ("graph_min_identity", "graph_min_identity"),
          ("use_quality", "use_quality"), ("arb_min_depth", "arb_min_depth")]


def _build_cfg(args) -> AssemblerConfig:
    cfg = AssemblerConfig()
    if args.config:
        with open(args.config) as fh:
            cfg = AssemblerConfig.from_json(fh.read())
    overrides = {field: getattr(args, flag) for flag, field in _FLAGS
                 if getattr(args, flag) is not None}
    if args.no_arbitrate:
        overrides["arbitrate"] = False
    return cfg.replace(**overrides) if overrides else cfg


def _load(args):
    from hga_tpu_torch.models.pipeline import load_reads

    return load_reads(args.short, args.long,
                      keep_quality=bool(args.use_quality))


def cmd_count(args) -> int:
    from hga_tpu_torch.models.spectrum import count_reads

    cfg = _build_cfg(args)
    pr_s, _ = _load(args)
    if pr_s is None:
        print("no short reads", file=sys.stderr)
        return 2
    res = count_reads(pr_s, cfg, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    res.save(os.path.join(args.outdir, "spectrum.npz"))
    with open(os.path.join(args.outdir, "spectrum_hist.tsv"), "w") as fh:
        for c, n in enumerate(res.hist):
            fh.write(f"{c}\t{int(n)}\n")
    _plot_spectrum(res, os.path.join(args.outdir, "spectrum.png"))
    print(json.dumps({"distinct_kmers": res.n_distinct, "k": res.k,
                      "solid_threshold": res.threshold,
                      "solid_kmers": int((res.count >= res.threshold).sum())}))
    return 0


def _plot_spectrum(res, path: str) -> None:
    """The spectrum as a log-y bar plot with the solid threshold marked
    (the reference's plot); best-effort: skipped without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        log.warning("matplotlib is not installed: no %s", path)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(range(1, len(res.hist)), res.hist[1:], width=1.0)
    ax.axvline(res.threshold, color="red", ls="--",
               label=f"solid threshold {res.threshold}")
    ax.set_xlabel(f"{res.k}-mer count")
    ax.set_ylabel("# distinct k-mers")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def cmd_seeds(args) -> int:
    from hga_tpu_torch.models.seeding import find_candidates

    cfg = _build_cfg(args)
    pr_s, _ = _load(args)
    if pr_s is None:
        print("no reads", file=sys.stderr)
        return 2
    res = find_candidates(pr_s, cfg, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    res.save(os.path.join(args.outdir, "candidates.npz"))
    print(json.dumps({"candidates": res.n_pairs, "overflow": res.overflow}))
    return 0


def cmd_overlap(args) -> int:
    from hga_tpu_torch.models.overlap import (compute_overlaps,
                                              compute_overlaps_cross)
    from hga_tpu_torch.models.seeding import find_candidates

    cfg = _build_cfg(args)
    pr_s, pr_l = _load(args)
    os.makedirs(args.outdir, exist_ok=True)
    if pr_s is not None and pr_l is not None:
        # judged config 3: long nanopore reads vs the short-read index
        ov = compute_overlaps_cross(pr_s, pr_l, cfg, device=args.device)
        names_a, names_b = pr_s.names, pr_l.names
        n_cands = ov.n
    else:
        pr = pr_s if pr_l is None else pr_l
        if pr is None:
            print("no reads", file=sys.stderr)
            return 2
        cands = find_candidates(pr, cfg, device=args.device)
        ov = compute_overlaps(pr, cands, cfg, device=args.device)
        names_a = names_b = pr.names
        n_cands = cands.n_pairs
    ov.save(os.path.join(args.outdir, "overlaps.npz"))
    with open(os.path.join(args.outdir, "overlaps.paf"), "w") as fh:
        fh.write(ov.to_paf(names_a, names_b))
    print(json.dumps({"candidates": int(n_cands), "overlaps": ov.n}))
    return 0


def cmd_assemble(args) -> int:
    """Config 4.  With --overlaps (a saved overlaps.npz, plus the read set it
    indexes via --reads-npz or --short/--long) only the graph + unitig stage
    runs; without it this aliases the full pipeline."""
    cfg = _build_cfg(args)
    if getattr(args, "overlaps", None):
        from hga_tpu_torch import convert
        from hga_tpu_torch.io.fastq import write_fasta
        from hga_tpu_torch.models.assembly import assemble

        if args.reads_npz:
            pr = convert.load_corrected(args.reads_npz)
        else:
            pr_s, pr_l = _load(args)
            pr = pr_l if pr_l is not None else pr_s
        if pr is None:
            print("need --reads-npz or --short/--long with --overlaps",
                  file=sys.stderr)
            return 2
        ov = convert.load_overlaps(args.overlaps)
        res = assemble(pr, ov, cfg, device=args.device)
        os.makedirs(args.outdir, exist_ok=True)
        write_fasta(os.path.join(args.outdir, "contigs.fasta"), res.contigs)
        with open(os.path.join(args.outdir, "assembly.gfa"), "w") as fh:
            fh.write(res.to_gfa(pr.names, pr.length))
        print(json.dumps({"contigs": len(res.contigs),
                          "edges_raw": res.n_edges_raw,
                          "edges_reduced": res.n_edges_reduced}))
        return 0

    from hga_tpu_torch.models.pipeline import run_pipeline

    pr_s, pr_l = _load(args)
    res = run_pipeline(pr_s, pr_l, cfg, args.outdir, resume=args.resume,
                       device=args.device)
    print(json.dumps(res.stats))
    return 0


def cmd_correct(args) -> int:
    from hga_tpu_torch.io.encode import unpack_read
    from hga_tpu_torch.io.fastq import write_fasta
    from hga_tpu_torch.models.correction import correct_long_reads

    cfg = _build_cfg(args)
    pr_s, pr_l = _load(args)
    if pr_s is None or pr_l is None:
        print("need both --short and --long", file=sys.stderr)
        return 2
    corr = correct_long_reads(pr_s, pr_l, cfg, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    corr.save(os.path.join(args.outdir, "corrected.npz"))
    write_fasta(os.path.join(args.outdir, "corrected.fasta"),
                [(corr.names[i], unpack_read(corr, i))
                 for i in range(corr.n_reads)])
    print(json.dumps({"corrected": corr.n_reads}))
    return 0


def cmd_eval(args) -> int:
    from hga_tpu_torch.io.fastq import iter_records
    from hga_tpu_torch.utils.evalx import (alignment_identity,
                                           evaluate_contigs,
                                           exact_contig_match,
                                           segment_identity)

    contigs = [(r.name, r.seq) for r in iter_records(args.contigs)]
    out = {}
    if args.reference:
        ref = "".join(r.seq for r in iter_records(args.reference))
        out.update(evaluate_contigs(contigs, ref, k=args.k or 21))
        if args.align:
            out.update(alignment_identity(contigs, ref, device=args.device))
        if args.segs:
            from hga_tpu_torch.parallel.mesh import auto_mesh

            out.update(segment_identity(contigs, ref, device=args.device,
                                        mesh=auto_mesh()))
    if args.exact:
        # byte-for-byte contig-set diff against another assembler's output
        ref_contigs = [(r.name, r.seq) for r in iter_records(args.exact)]
        out.update(exact_contig_match(contigs, ref_contigs))
    from hga_tpu_torch.parallel.hostpart import is_main

    if is_main():
        print(json.dumps(out))
    return 0


def cmd_simulate(args) -> int:
    from hga_tpu_torch.io.fastq import write_fasta, write_fastq
    from hga_tpu_torch.utils import sim

    ds = sim.make_dataset(genome_len=args.genome_len,
                          short_cov=args.short_cov, long_cov=args.long_cov,
                          seed=args.seed, short_err=args.short_err,
                          long_err=args.long_err, return_quals=args.fastq)
    os.makedirs(args.outdir, exist_ok=True)
    write_fasta(os.path.join(args.outdir, "genome.fasta"),
                [("genome", ds.genome)])
    if args.fastq:
        write_fastq(os.path.join(args.outdir, "short.fastq"),
                    list(zip(ds.short_names, ds.short_seqs, ds.short_quals)))
    else:
        write_fasta(os.path.join(args.outdir, "short.fasta"),
                    list(zip(ds.short_names, ds.short_seqs)))
    if ds.long_seqs:
        write_fasta(os.path.join(args.outdir, "long.fasta"),
                    list(zip(ds.long_names, ds.long_seqs)))
    print(json.dumps({"genome_len": len(ds.genome),
                      "short_reads": len(ds.short_seqs),
                      "long_reads": len(ds.long_seqs)}))
    return 0


def cmd_bench(args) -> int:
    from hga_tpu_torch.utils.benchmarks import run_benchmark

    from hga_tpu_torch.parallel.hostpart import is_main

    out = run_benchmark(what=args.what, n_pairs=args.pairs,
                        device=args.device)
    if is_main():
        print(json.dumps(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hga-torch",
        description="hybrid genome assembler (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in [("count", cmd_count), ("seeds", cmd_seeds),
                     ("overlap", cmd_overlap), ("assemble", cmd_assemble),
                     ("pipeline", cmd_assemble), ("correct", cmd_correct)]:
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--short", nargs="*", default=[],
                       help="short-read FASTQ/FASTA files")
        p.add_argument("--long", nargs="*", default=[],
                       help="long-read FASTQ/FASTA files")
        if name == "assemble":
            p.add_argument("--overlaps", metavar="NPZ",
                           help="saved overlaps.npz artifact: run only the "
                                "graph + unitig stage (config 4)")
            p.add_argument("--reads-npz", metavar="NPZ",
                           help="saved PackedReads artifact the overlaps "
                                "index (e.g. corrected.npz)")
        p.set_defaults(fn=fn)
    p = sub.add_parser("eval")
    p.add_argument("--contigs", required=True)
    p.add_argument("--reference", help="reference genome FASTA")
    p.add_argument("--exact", metavar="FASTA",
                   help="another assembler's contigs: byte-for-byte set diff")
    p.add_argument("--align", action="store_true",
                   help="alignment-based identity via the long-read engine")
    p.add_argument("--segs", action="store_true",
                   help="placement-free segment identity: every contig "
                        "segment swept against the whole genome (K1''s "
                        "shared-target mode)")
    p.add_argument("-k", type=int, default=21)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    _add_profile(p)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("simulate")
    p.add_argument("-o", "--outdir", default="hga_sim")
    p.add_argument("--genome-len", type=int, default=50_000)
    p.add_argument("--short-cov", type=float, default=30.0)
    p.add_argument("--long-cov", type=float, default=20.0)
    p.add_argument("--short-err", type=float, default=0.01)
    p.add_argument("--long-err", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fastq", action="store_true",
                   help="write short reads as FASTQ with per-base "
                        "qualities (enables --use-quality downstream)")
    _add_profile(p)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("bench")
    p.add_argument("--what", default="myers",
                   choices=["myers", "sw", "count", "correction",
                            "pipeline", "scaling", "comm"])
    p.add_argument("--pairs", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    _add_profile(p)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_bench)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # under torchrun every rank joins the world before any stage touches a
    # device (a no-op without WORLD_SIZE)
    from hga_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device=getattr(args, "device", "cpu"))
    if args.profile:
        return _profiled(args)
    return args.fn(args)


def _profiled(args) -> int:
    """Run the command under torch.profiler and write its Chrome trace to
    DIR/trace.json, also when the command raises (the reference writes a
    jax.profiler trace to DIR)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(getattr(args, "device", "cpu")).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(args.profile, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        return args.fn(args)
    finally:
        if cuda and torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))


if __name__ == "__main__":
    sys.exit(main())
