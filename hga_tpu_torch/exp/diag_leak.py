"""Leak analysis for the copy-aware candidate filter: of the MISPLACED
candidates that survive, how many are (a) anchored through a rare-seed
frequency-noise leak, against (b) kept ambiguous because their bucket had
no anchored depth?  It drives the filter's parameter choices with data.

Counterpart of exp/diag_leak.py, reading the candidates' stats through the
hook ``models/overlap_long._CAND_DEBUG``.

    python -m hga_tpu_torch.exp.diag_leak [genome_kb=600] [--device cuda|cpu]
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from hga_tpu_torch.exp.common import positional, split_device


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.WARNING)
    flags, device = split_device(argv)
    args = positional(flags)
    gkb = float(args[0]) if args else 600.0
    G = int(gkb * 1000)

    from hga_tpu_torch.exp.diag_repeat_corr import (base_cfg, classify,
                                                    derive, repeat_reads)
    from hga_tpu_torch.models import overlap_long as OL
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    genome, annot, _, pr_s, pr_l, s_truth, l_truth = repeat_reads(G)

    cfg0 = base_cfg()
    spec = count_reads(pr_s, cfg0, device=dev)
    cfg, peak = derive(cfg0, spec, float(pr_s.length.mean()))
    solid = spec.solid_set()
    idx = OL.build_seed_index(pr_s, cfg, solid=solid, device=dev)

    OL._CAND_DEBUG = {}
    try:
        cands = OL.find_candidates_cross_indexed(
            pr_s, pr_l, cfg, solid=solid, index=idx,
            depth_cap=cfg.corr_depth_cap, rare_cap=cfg.corr_rare_seed_freq,
            anchor_min=cfg.corr_anchor_min, device=dev)
        dbg = {k: np.concatenate(v) for k, v in OL._CAND_DEBUG.items()}
    finally:
        OL._CAND_DEBUG = None
    mis, in_rep, fam = classify(cands, pr_s, pr_l, s_truth, l_truth, annot)
    anch = dbg["rare_cnt"] > 0
    print(f"peak {peak} rare_cap {cfg.corr_rare_seed_freq} "
          f"depth_cap {cfg.corr_depth_cap}")
    for f in ("rrna", "is", "tandem", "unique"):
        m = fam == f if f != "unique" else ~in_rep
        if not m.any():
            continue
        mm = m & mis
        print(f"{f}: kept {int(m.sum())}, misplaced {int(mm.sum())} "
              f"({100 * mis[m].mean():.2f}%)")
        if mm.any():
            print(f"   misplaced survivors: anchored {int(anch[mm].sum())} "
                  f"(rare-leak), ambiguous-kept {int((~anch[mm]).sum())} "
                  f"(bucket A<min)")
            print(f"   misplaced rare_cnt histogram: "
                  f"{np.bincount(dbg['rare_cnt'][mm].clip(0, 6))}")
            mc = np.percentile(dbg["min_comb"][mm], [10, 50, 90]).round(0)
            print(f"   misplaced min_comb deciles: {mc}")
            print(f"   misplaced bucket-A deciles: "
                  f"{np.percentile(dbg['A'][mm], [10, 50, 90]).round(0)}")
        ok = m & ~mis
        if ok.any():
            print(f"   well-placed: anchored {100 * anch[ok].mean():.1f}%, "
                  f"rare_cnt median {np.median(dbg['rare_cnt'][ok]):.0f}, "
                  f"min_comb median {np.median(dbg['min_comb'][ok]):.0f}")


if __name__ == "__main__":
    main()
