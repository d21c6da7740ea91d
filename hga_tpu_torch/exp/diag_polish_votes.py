"""Polish-stage vote forensics: at each rRNA copy-distinguishing site of an
assembled contig, what does the pileup vote, the copy's own base or the
family-master base?  It tells candidate-misplacement averaging from faults
of the consensus logic.

Counterpart of exp/diag_polish_votes.py, reading the votes through the
hook ``models/correction._DEBUG_SINK``.  The contig must come from the
repeat genome of `genome_kb` (``sim.repeat_genome``, seed 42).

    python -m hga_tpu_torch.exp.diag_polish_votes [contig_fasta]
        [genome_kb=1500] [--device cuda|cpu]
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from hga_tpu_torch.exp.common import split_device, tmp_path


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.WARNING)
    args, device = split_device(argv)
    path = (args[0] if len(args) > 0
            else tmp_path("scale_15rep_v2/contigs.fasta"))
    gkb = float(args[1]) if len(args) > 1 else 1500.0

    from hga_tpu_torch.exp.diag_repeat_corr import (base_cfg, derive,
                                                    master_base)
    from hga_tpu_torch.io.encode import pack_reads, revcomp_str
    from hga_tpu_torch.io.fastq import iter_records
    from hga_tpu_torch.models import correction as MC
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.utils import sim
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    genome, annot = sim.repeat_genome(int(gkb * 1000), seed=42,
                                      return_annotation=True)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    contig = next(iter_records(path)).seq

    cfg0 = base_cfg()
    spec = count_reads(pr_s, cfg0, device=dev)
    cfg, peak = derive(cfg0, spec, float(pr_s.length.mean()))
    solid = spec.solid_set()
    print(f"peak {peak} rare {cfg.corr_rare_seed_freq} "
          f"depth_cap {cfg.corr_depth_cap}", flush=True)

    # map each rRNA divergent site to a contig coordinate through its OWN
    # 21-mer (the unpolished contig still carries the variant where the
    # assembly used same-copy reads)
    sites = []          # (contig position of the centre, own code, master)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    fams = {}
    for c in annot:
        fams.setdefault(c.family, []).append(c)
    for fam, copies in fams.items():
        if not fam.startswith("rrna"):
            continue
        for c in copies:
            for p in c.mut_pos:
                p = int(p)
                if p < 10 or p + 11 > len(genome):
                    continue
                mb = master_base(genome, copies, c, p, comp)
                if mb == genome[p]:
                    continue
                own = genome[p - 10 : p + 11]
                i = contig.find(own)
                if i < 0:
                    i = contig.find(revcomp_str(own))
                    if i < 0 or contig.find(revcomp_str(own), i + 1) >= 0:
                        continue
                    sites.append((i + 10, code[comp[genome[p]]],
                                  code[comp[mb]]))
                else:
                    if contig.find(own, i + 1) >= 0:
                        continue
                    sites.append((i + 10, code[genome[p]], code[mb]))
    print(f"{len(sites)} mappable rRNA divergent sites", flush=True)

    MC._DEBUG_SINK = {}
    try:
        out = MC.polish_contigs([("contig_0", contig)], pr_s, cfg,
                                solid=solid, device=dev)
        votes = MC._DEBUG_SINK["votes"]       # (nb, Lpad, N_SYM)
    finally:
        MC._DEBUG_SINK = None
    own_w = mas_w = 0
    det = []
    for cp, ob, mb in sites:
        v = votes[0, cp]
        if v[ob] >= v[mb]:
            own_w += 1
        else:
            mas_w += 1
        det.append((int(v[ob]), int(v[mb]), int(v.sum())))
    det = np.array(det)
    print(f"votes at sites: own wins {own_w}, master wins {mas_w}")
    if det.size:
        print(f"own votes median {np.median(det[:,0]):.0f}, "
              f"master votes median {np.median(det[:,1]):.0f}, "
              f"depth median {np.median(det[:,2]):.0f}")
    # after polish: does the polished sequence keep the own variant?
    pol = out[0][1]
    kept = sum(1 for cp, ob, mb in sites
               if "ACGT"[ob] == (pol[cp] if cp < len(pol) else "N"))
    print(f"(approx) polished base equals own at {kept}/{len(sites)} "
          f"sites (coordinate drift makes this a lower bound)")


if __name__ == "__main__":
    main()
