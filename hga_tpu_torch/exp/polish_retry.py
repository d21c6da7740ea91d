"""Re-polish a run's saved contigs with N passes, evaluating after each.

Counterpart of exp/polish_retry.py: the short reads are simulated again
(30x 100 bp, 1% error, seed + 1, on the random genome of `seed`), each pass
runs ``polish_contigs`` (K2' on the card) over the previous pass's output,
and ``polished.fasta`` and ``polish_retry.json`` are written into `rundir`
(the pipeline's ``polished.fasta`` there is overwritten).

    python -m hga_tpu_torch.exp.polish_retry [rundir] [passes] [genome_mb]
        [seed] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional

from hga_tpu_torch.exp.common import split_device, sync, tmp_path


def main(argv: Optional[List[str]] = None) -> Dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args, device = split_device(argv)
    rundir = args[0] if len(args) > 0 else tmp_path("scale4_r4")
    passes = int(args[1]) if len(args) > 1 else 2
    gmb = float(args[2]) if len(args) > 2 else 4.6
    seed = int(args[3]) if len(args) > 3 else 42

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.io.fastq import iter_records, write_fasta
    from hga_tpu_torch.models.correction import polish_contigs
    from hga_tpu_torch.utils import sim
    from hga_tpu_torch.utils.device import resolve_device
    from hga_tpu_torch.utils.evalx import evaluate_contigs

    dev = resolve_device(device)
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=seed + 1)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    del ss
    contigs = [(r.name, r.seq)
               for r in iter_records(f"{rundir}/contigs.fasta")]
    cfg = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                          min_shared_minimizers=2, min_overlap_len=500,
                          min_identity=0.75, corr_batch_pairs=4096,
                          min_contig_len=2000)
    out = {}
    polished = contigs
    for p in range(passes):
        t0 = time.perf_counter()
        polished = polish_contigs(polished, pr_s, cfg, device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        ev = evaluate_contigs(polished, genome, k=21)
        out[f"pass{p + 1}"] = dict(seconds=round(dt, 1), **ev)
        print(json.dumps(out[f"pass{p + 1}"]), flush=True)
    write_fasta(f"{rundir}/polished.fasta", polished)
    with open(f"{rundir}/polish_retry.json", "w") as fh:
        json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
