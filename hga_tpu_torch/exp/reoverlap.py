"""Re-run long overlaps and assembly from a saved ``corrected.npz`` with the
current engine (K1' on the card), then evaluate against the simulated
genome.

Counterpart of exp/reoverlap.py: ``overlaps.npz`` and
``reoverlap_metrics.json`` go into `outdir`.  ``--polish`` does what the
JAX script does: it writes the assembled ``contigs.fasta`` into `outdir`
and polishes nothing (the script imports ``polish_contigs`` and never
calls it; the port keeps that, as a reference quirk).

    python -m hga_tpu_torch.exp.reoverlap [rundir] [outdir] [genome_mb]
        [seed] [--polish] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

from hga_tpu_torch.exp.common import positional, split_device, sync, tmp_path


def main(argv: Optional[List[str]] = None) -> Dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    flags, device = split_device(argv)
    args = positional(flags)
    rundir = args[0] if len(args) > 0 else tmp_path("scale_4.6mb")
    outdir = args[1] if len(args) > 1 else tmp_path("reoverlap")
    gmb = float(args[2]) if len(args) > 2 else 4.6
    seed = int(args[3]) if len(args) > 3 else 42
    do_polish = "--polish" in flags
    os.makedirs(outdir, exist_ok=True)

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import PackedReads
    from hga_tpu_torch.models.assembly import assemble
    from hga_tpu_torch.models.overlap_long import compute_overlaps_long
    from hga_tpu_torch.utils import sim
    from hga_tpu_torch.utils.device import resolve_device
    from hga_tpu_torch.utils.evalx import evaluate_contigs

    dev = resolve_device(device)
    pr = PackedReads.load(f"{rundir}/corrected.npz")
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    cfg = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                          min_shared_minimizers=2, min_overlap_len=500,
                          min_identity=0.75, corr_depth_cap=20,
                          corr_batch_pairs=4096, min_contig_len=2000)

    t0 = time.perf_counter()
    ov = compute_overlaps_long(pr, cfg, device=dev)
    sync(dev)
    t_ov = time.perf_counter() - t0
    ov.save(f"{outdir}/overlaps.npz")
    print(f"overlaps: {ov.n} in {t_ov:.0f}s", flush=True)

    t0 = time.perf_counter()
    res = assemble(pr, ov, cfg, device=dev)
    sync(dev)
    t_asm = time.perf_counter() - t0
    ev = evaluate_contigs(res.contigs, genome, k=21)
    out = dict(overlap_seconds=round(t_ov, 1),
               assembly_seconds=round(t_asm, 1), n_overlaps=ov.n, **ev)
    print(json.dumps(out, indent=2), flush=True)

    if do_polish:
        from hga_tpu_torch.io.fastq import write_fasta

        write_fasta(f"{outdir}/contigs.fasta", res.contigs)
    with open(f"{outdir}/reoverlap_metrics.json", "w") as fh:
        json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
