"""Benchmark entry of the port: prints ONE JSON line with the headline
metric, the counterpart of the repo root's ``bench.py``.

    python -m hga_tpu_torch.bench [--device cpu]

Headline: overlap-DP GCUPS per chip on the production overlap engine, K1'
(ops/myers_cuda.myers_batch_cuda), through
``utils/benchmarks.bench_myers(n_pairs=8192)``: N 8192, Lq 128, Lt 192,
cells the full Lq x Lt matrix of each pair, as the reference counts them.
``vs_baseline`` divides by the result's ``baseline_gcups``, 0.7 of the H100
roofline that bench_myers computes for this shape (utils/benchmarks), not
by the TPU's 140 GCUPS of the reference's line.  The secondary engine, the
scored-SW refine K3' (``bench_sw(n_pairs=4096)``: Lq 128, Lt 256, band 64),
is reported beside it as ``scored_sw_gcups`` and ``scored_sw_impl``, or
``scored_sw_error``: it never sinks the headline.

On the card the line before the JSON names the card and its power limit
(nvidia-smi's ``name, power.limit``).  With ``--device cpu`` the wrappers
run their plain versions and every number is the CPU's (``impl`` "plain").
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Optional, Sequence

from hga_tpu_torch.utils.benchmarks import bench_myers, bench_sw, card_line
from hga_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    res = bench_myers(n_pairs=8192, device=dev)
    line = {
        "metric": "overlap_dp_gcups_per_chip",
        "value": round(res["gcups"], 3),
        "unit": "GCUPS",
        "vs_baseline": round(res["gcups"] / res["baseline_gcups"], 4),
    }
    try:
        sw = bench_sw(n_pairs=4096, device=dev)
        line["scored_sw_gcups"] = round(sw["gcups"], 3)
        line["scored_sw_impl"] = sw["impl"]
    except Exception as e:  # the secondary engine never sinks the headline
        traceback.print_exc()
        line["scored_sw_error"] = repr(e)[:120]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
