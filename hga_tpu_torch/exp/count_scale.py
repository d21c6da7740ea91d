"""Judged config 1 on its own at scale: k = 21 counting and the spectrum
over the E. coli-scale short-read set (30x 100 bp reads of a seeded random
genome, 4.6 Mb by default), timed twice.

Counterpart of exp/count_scale.py, with the same keys: ``seconds_first``
is the first ``count_reads`` (on the card it includes the allocator's and
the libraries' first use), ``seconds_warm`` the second; each clock is read
after ``torch.cuda.synchronize``.

    python -m hga_tpu_torch.exp.count_scale [genome_mb] [out_json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from hga_tpu_torch.exp.common import split_device, sync, tmp_path


def main(argv: Optional[List[str]] = None) -> Dict:
    args, device = split_device(argv)
    gmb = float(args[0]) if len(args) > 0 else 4.6
    out_path = args[1] if len(args) > 1 else tmp_path(
        "count21_metrics.json")
    G = int(gmb * 1_000_000)

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.spectrum import count_reads
    from hga_tpu_torch.utils import sim
    from hga_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    genome = sim.random_genome(G, seed=42)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    pr = pack_reads(ss, names=sn, pad_len=112)
    del ss
    cfg = AssemblerConfig(k=21, batch_reads=4096)   # the judged k

    # the first pass pays the first use of the device's libraries; the
    # second is the number
    t0 = time.perf_counter()
    spec = count_reads(pr, cfg, device=dev)
    sync(dev)
    t_warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = count_reads(pr, cfg, device=dev)
    sync(dev)
    t = time.perf_counter() - t0

    out = dict(
        config="judged-1 k-mer count + spectrum",
        k=21, n_reads=pr.n_reads, genome_mb=gmb,
        seconds_warm=round(t, 1), seconds_first=round(t_warmup, 1),
        reads_per_s=round(pr.n_reads / t, 1),
        kmers_per_s=round(pr.n_reads * (100 - 21 + 1) / t, 1),
        distinct_kmers=int(spec.n_distinct),
        solid_threshold=int(spec.threshold),
        genome_kmers_expected=G - 20,
    )
    print(json.dumps(out, indent=2), flush=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
