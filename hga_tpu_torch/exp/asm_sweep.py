"""Assembly-stage parameter sweep from saved stage artifacts.

Counterpart of exp/asm_sweep.py: only config 4 (graph and unitigs) runs,
from a pipeline run's ``corrected.npz`` and ``overlaps.npz``, under nine
variants of the scale-run config; each prints one JSON line with its
evaluation against the simulated genome, and a variant that raises prints
``<name>: FAILED <error>`` and is skipped.

    python -m hga_tpu_torch.exp.asm_sweep [rundir] [genome_mb] [genome_seed]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from hga_tpu_torch.exp.common import split_device, sync, tmp_path

VARIANTS = (
    ("base", {}),
    ("score0", dict(min_overlap_score=0)),
    ("hang5", dict(hang_frac=0.05)),
    ("hang10", dict(hang_frac=0.10)),
    ("fuzz400", dict(fuzz=400)),
    ("deg32", dict(max_out_degree=32)),
    ("tip6", dict(tip_max_len=6)),
    ("hang10+fuzz400", dict(hang_frac=0.10, fuzz=400)),
    ("hang10+tip6+deg32", dict(hang_frac=0.10, tip_max_len=6,
                               max_out_degree=32)),
)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args, device = split_device(argv)
    rundir = args[0] if len(args) > 0 else tmp_path("scale_4.6mb")
    gmb = float(args[1]) if len(args) > 1 else 4.6
    seed = int(args[2]) if len(args) > 2 else 42

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import PackedReads
    from hga_tpu_torch.models.assembly import assemble
    from hga_tpu_torch.models.overlap import OverlapRecords
    from hga_tpu_torch.utils import sim
    from hga_tpu_torch.utils.device import resolve_device
    from hga_tpu_torch.utils.evalx import evaluate_contigs

    dev = resolve_device(device)
    pr = PackedReads.load(f"{rundir}/corrected.npz")
    ov = OverlapRecords.load(f"{rundir}/overlaps.npz")
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    print(f"{pr.n_reads} reads, {ov.n} overlaps", flush=True)

    # the scale-run base config (exp/scale_run.py)
    base = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, corr_depth_cap=20,
                           corr_batch_pairs=4096, min_contig_len=2000)
    rows = []
    for name, kw in VARIANTS:
        cfg = base.replace(**kw)
        t0 = time.perf_counter()
        try:
            res = assemble(pr, ov, cfg, device=dev)
            sync(dev)
        except Exception as e:
            print(f"{name}: FAILED {e}", flush=True)
            continue
        dt = time.perf_counter() - t0
        ev = evaluate_contigs(res.contigs, genome, k=21)
        rows.append({"variant": name, "seconds": round(dt, 1), **ev})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
