"""Repeat-correction diagnostic: does correction average the copies of a
repeat family, and does the copy-aware candidate filter
(corr_rare_seed_freq) stop it?  Truth-labelled on the simulator's repeat
annotations.

Counterpart of exp/diag_repeat_corr.py.  On a repeat-bearing genome
(``sim.repeat_genome``, 600 kb by default) it measures:

1. candidate placement: each correction candidate implies a backbone
   position for the short read; with the reads' true loci (encoded in the
   simulated names) a candidate is MISPLACED when the implied genome locus
   is more than `tol` from the read's true locus, i.e. the read is piled
   onto the wrong repeat copy.  Reported with the filter off and on.
2. the consensus outcome (skipped with ``--no-correct``): at every
   copy-distinguishing site, the corrected reads are probed for the copy's
   OWN k-mer against the FAMILY-MASTER k-mer (the site's base replaced by
   the other copies' majority base); family averaging shows as master
   k-mers displacing own k-mers.

    python -m hga_tpu_torch.exp.diag_repeat_corr [genome_kb=600]
        [--no-correct] [--device cuda|cpu]
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from hga_tpu_torch.exp.common import positional, split_device, sync


def derive(cfg, spec, mean_l):
    """The knobs run_pipeline derives from the spectrum."""
    hist = spec.hist
    peak = int(np.argmax(hist[spec.threshold:]) + spec.threshold)
    base_cov = peak * mean_l / max(mean_l - cfg.k + 1, 1.0)
    return cfg.replace(
        max_seed_freq=max(cfg.max_seed_freq, 4 * peak),
        corr_depth_cap=max(8, int(np.ceil(0.7 * base_cov))),
        corr_rare_seed_freq=int(np.ceil(1.8 * peak))), peak


def truth_of_names(names):
    out = []
    for nm in names:
        p = nm.split("_")
        out.append((int(p[2]), int(p[3])))    # (start, strand)
    return np.array(out, np.int64)


def classify(cands, pr_s, pr_l, s_truth, l_truth, annot, tol=300):
    """Which candidates imply a wrong genome locus: (misplaced, in a
    repeat, the family of the read's true locus)."""
    a, b, rel, diag = cands
    la = pr_s.length[a].astype(np.int64)
    lb = pr_l.length[b].astype(np.int64)
    pos_bb = np.where(rel == 1, diag + lb - la, -diag)    # read pos on bb
    bs, bstr = l_truth[b, 0], l_truth[b, 1]
    # backbone strand 1: backbone base 0 is the genome END of the span
    implied = np.where(bstr == 1, bs + lb - pos_bb - la, bs + pos_bb)
    true_pos = s_truth[a, 0]
    err = np.abs(implied - true_pos)
    mis = err > tol
    # family of the read's true locus (repeat copies may differ per family)
    fam = np.full(len(a), "unique", dtype=object)
    for c in annot:
        m = (true_pos >= c.start - 60) & (true_pos < c.end - 40)
        base = c.family.rstrip("0123456789") if c.family != "rrna" else "rrna"
        fam[m] = ("tandem" if c.family.startswith("tandem")
                  else ("is" if c.family.startswith("is") else base))
    in_rep = fam != "unique"
    return mis, in_rep, fam


def master_base(genome, copies, c, p, comp):
    """The majority of the base homologous to genome[p] (copy c) in the
    family's other copies, each mapped through its own placement."""
    off = (p - c.start) if c.strand == 0 else (c.end - 1 - p)
    votes = []
    for c2 in copies:
        if c2 is c:
            continue
        q = (c2.start + off if c2.strand == 0
             else c2.end - 1 - off)
        bb = genome[q]
        if c2.strand != c.strand:
            bb = comp[bb]
        votes.append(bb)
    vals, cnts = np.unique(votes, return_counts=True)
    return str(vals[np.argmax(cnts)])


def probe_sites(genome, annot, texts, l_truth, k=21):
    """Per copy-distinguishing site: own-variant against master-variant
    k-mer occurrences, counted only inside the reads whose TRUE span
    overlaps that copy (master k-mers occur legitimately in other copies'
    reads, so a global count always favours the master)."""
    from hga_tpu_torch.io.encode import revcomp_str

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fams = {}
    for c in annot:
        fams.setdefault(c.family, []).append(c)
    rs = l_truth[:, 0]
    rl = np.array([len(t) for t in texts], np.int64)
    own_kept = master_won = both = neither = 0
    for fam, copies in fams.items():
        if fam.startswith("tandem") or len(copies) < 2:
            continue
        for c in copies:
            sel = np.nonzero((rs < c.end) & (rs + rl > c.start))[0]
            sub = "\n".join(texts[i] for i in sel)
            for p in c.mut_pos:
                p = int(p)
                if p - k // 2 < 0 or p + k // 2 + 1 > len(genome):
                    continue
                mb = master_base(genome, copies, c, p, comp)
                if mb == genome[p]:
                    continue        # other copies agree with this one here
                own = genome[p - k // 2 : p + k // 2 + 1]
                mas = own[: k // 2] + mb + own[k // 2 + 1 :]
                n_own = sub.count(own) + sub.count(revcomp_str(own))
                n_mas = sub.count(mas) + sub.count(revcomp_str(mas))
                if n_own > n_mas:
                    own_kept += 1
                elif n_mas > n_own:
                    master_won += 1
                elif n_own > 0:
                    both += 1
                else:
                    neither += 1
    return dict(own_kept=own_kept, master_won=master_won, tied=both,
                no_signal=neither)


def residual_identity(genome, annot, texts, l_truth, k=21):
    """Per corrected read: the share of its k-mers found at its TRUE genome
    locus (name-encoded), the direct predictor of same-copy overlap
    identity; split by whether the read's span meets a repeat copy."""
    from hga_tpu_torch.utils.evalx import _kmers_u64

    vals_rep, vals_uni = [], []
    G = len(genome)
    for i, t in enumerate(texts):
        if len(t) < k + 10:
            continue
        s = int(l_truth[i, 0])
        e = min(G, s + len(t) + 200)
        win = np.unique(_kmers_u64(genome[max(0, s - 200) : e], k,
                                   canonical=True))
        ck = _kmers_u64(t, k, canonical=True)
        if ck.size == 0 or win.size == 0:
            continue
        pos = np.clip(np.searchsorted(win, ck), 0, win.size - 1)
        ident = float((win[pos] == ck).mean())
        in_rep = any(c.start < s + len(t) and c.end > s for c in annot)
        (vals_rep if in_rep else vals_uni).append(ident)
    q = lambda v: (round(float(np.median(v)), 5),
                   round(float(np.percentile(v, 10)), 5),
                   len(v)) if v else (0, 0, 0)
    return dict(repeat_reads=q(vals_rep), unique_reads=q(vals_uni))


def repeat_reads(G: int):
    """The judged read model on sim.repeat_genome(G, seed 42): (genome,
    annotation, short reads, long reads, short truth, long truth)."""
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.utils import sim

    genome, annot = sim.repeat_genome(G, seed=42, return_annotation=True)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    ls, ln = sim.simulate_long_reads(genome, coverage=20.0, mean_len=8000,
                                     min_len=1000, error_rate=0.10, seed=44)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    pr_l = pack_reads(ls, names=ln, category=[1] * len(ls), pad_len=pad_l)
    return genome, annot, ls, pr_s, pr_l, truth_of_names(sn), \
        truth_of_names(ln)


def base_cfg():
    from hga_tpu_torch.config import AssemblerConfig

    return AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, corr_batch_pairs=4096)


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    flags, device = split_device(argv)
    args = positional(flags)
    gkb = float(args[0]) if args else 600.0
    do_correct = "--no-correct" not in flags
    G = int(gkb * 1000)

    from hga_tpu_torch.io.encode import decode_bases, unpack_codes
    from hga_tpu_torch.models.correction import correct_long_reads
    from hga_tpu_torch.models.overlap_long import (
        build_seed_index, find_candidates_cross_indexed)
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    genome, annot, ls, pr_s, pr_l, s_truth, l_truth = repeat_reads(G)
    print(f"genome {G} bp, {len(annot)} repeat copies, "
          f"{pr_s.n_reads} short / {pr_l.n_reads} long reads", flush=True)

    cfg0 = base_cfg()
    spec = count_reads(pr_s, cfg0, device=dev)
    cfg, peak = derive(cfg0, spec, float(pr_s.length.mean()))
    print(f"peak {peak}; max_seed_freq {cfg.max_seed_freq}, depth_cap "
          f"{cfg.corr_depth_cap}, rare_cap {cfg.corr_rare_seed_freq}",
          flush=True)
    solid = spec.solid_set()
    idx = build_seed_index(pr_s, cfg, solid=solid, device=dev)

    for label, rcap in (("filter OFF", 0), ("filter ON",
                                            cfg.corr_rare_seed_freq)):
        t0 = time.perf_counter()
        cands = find_candidates_cross_indexed(
            pr_s, pr_l, cfg, solid=solid, index=idx,
            depth_cap=cfg.corr_depth_cap, rare_cap=rcap,
            anchor_min=cfg.corr_anchor_min, device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        mis, in_rep, fam = classify(cands, pr_s, pr_l, s_truth, l_truth,
                                    annot)
        n = len(cands[0])
        print(f"[{label}] {n} candidates in {dt:.0f}s: "
              f"misplaced {mis.sum()} ({100*mis.mean():.2f}%); "
              f"in-repeat {in_rep.sum()} of which misplaced "
              f"{mis[in_rep].sum()} ({100*mis[in_rep].mean():.2f}%)",
              flush=True)
        for f in ("rrna", "is", "tandem"):
            m = fam == f
            if m.any():
                print(f"    {f}: {int(m.sum())} cands, misplaced "
                      f"{int(mis[m].sum())} ({100*mis[m].mean():.2f}%)",
                      flush=True)

    if not do_correct:
        return
    # calibration: raw (uncorrected) reads keep the own variant weakly
    # (21-mer survival ~0.9^21 = 11% a read) and near-zero master signal
    res = probe_sites(genome, annot, ls, l_truth)
    print(f"[raw reads] copy-distinguishing sites: {res}", flush=True)
    for label, rcap in (("corr OFF", 0), ("corr ON",
                                          cfg.corr_rare_seed_freq)):
        t0 = time.perf_counter()
        cfg_r = cfg.replace(corr_rare_seed_freq=rcap)
        corr = correct_long_reads(pr_s, pr_l, cfg_r, solid=solid,
                                  device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        codes = unpack_codes(corr.packed)
        texts = [decode_bases(codes[i, : corr.length[i]])
                 for i in range(corr.n_reads)]
        res = probe_sites(genome, annot, texts, l_truth)
        print(f"[{label}] corrected in {dt:.0f}s; "
              f"copy-distinguishing sites: {res}", flush=True)
        rid = residual_identity(genome, annot, texts, l_truth)
        print(f"[{label}] corrected-read k-mer identity vs own locus: "
              f"{rid}", flush=True)


if __name__ == "__main__":
    main()
