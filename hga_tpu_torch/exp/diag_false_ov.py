"""Classify a run's saved overlaps as true or false against the simulator's
truth.

Counterpart of exp/diag_false_ov.py, which runs at import on
/tmp/scale_4.6mb; here the run directory is the first argument (the same
name under the temporary directory by default).  The reads' names encode
their loci (lr_{i}_{start}_{strand}_{genome_len}); an overlap record is
TRUE when the two reads' genome intervals meet over >= 500 bases.  It
prints the identity, block length, score and distance distributions of the
true and false records, strand agreement, the first 20 false records and
what each identity floor would keep.  Host numpy only: ``--device`` is
taken and not used.

    python -m hga_tpu_torch.exp.diag_false_ov [rundir]
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from hga_tpu_torch.exp.common import split_device, tmp_path


def main(argv: Optional[List[str]] = None) -> None:
    from hga_tpu_torch.io.encode import PackedReads
    from hga_tpu_torch.models.overlap import OverlapRecords

    args, _ = split_device(argv)
    rundir = args[0] if len(args) > 0 else tmp_path("scale_4.6mb")
    pr = PackedReads.load(f"{rundir}/corrected.npz")
    ov = OverlapRecords.load(f"{rundir}/overlaps.npz")

    starts = np.array([int(nm.split("_")[2]) for nm in pr.names], np.int64)
    glen = np.array([int(nm.split("_")[4]) for nm in pr.names], np.int64)
    ends = starts + glen

    sa, ea = starts[ov.a], ends[ov.a]
    sb, eb = starts[ov.b], ends[ov.b]
    inter = np.minimum(ea, eb) - np.maximum(sa, sb)
    true = inter >= 500

    ident = ov.identity()
    blk = np.maximum(ov.a_end - ov.a_start, ov.b_end - ov.b_start)

    print(f"records: {ov.n}  true: {true.sum()}  false: {(~true).sum()}")
    for name, m in (("TRUE ", true), ("FALSE", ~true)):
        if m.sum() == 0:
            continue
        print(f"{name}: n={m.sum()}")
        for fn, v in (("ident", ident), ("blk", blk), ("score", ov.score),
                      ("dist", ov.dist)):
            q = np.percentile(v[m], [0, 5, 25, 50, 75, 95, 100])
            print(f"  {fn:6s} " + " ".join(f"{x:9.3f}" for x in q))

    # strand agreement on true overlaps: rel should equal strand_a ^ strand_b
    strand = np.array([int(nm.split("_")[3]) for nm in pr.names], np.int8)
    agree = (strand[ov.a] ^ strand[ov.b]) == ov.rel
    print(f"strand-consistent: true {agree[true].mean():.4f} "
          f"false {agree[~true].mean() if (~true).any() else 1:.4f}")

    # the false records in detail (first 20)
    for i in np.nonzero(~true)[0][:20]:
        print(f"  false a={ov.a[i]}@{sa[i]} b={ov.b[i]}@{sb[i]} "
              f"rel={ov.rel[i]} blk={blk[i]} ident={ident[i]:.3f} "
              f"dist={ov.dist[i]} alen={ov.a_len[i]} blen={ov.b_len[i]} "
              f"a[{ov.a_start[i]}:{ov.a_end[i]}] "
              f"b[{ov.b_start[i]}:{ov.b_end[i]}]")

    # what each identity floor keeps
    for thr in (0.75, 0.80, 0.85, 0.88, 0.90, 0.92):
        tk = (ident >= thr)[true].sum()
        fk = (ident >= thr)[~true].sum()
        print(f"ident>={thr:.2f}: keeps {tk}/{true.sum()} true, "
              f"{fk}/{(~true).sum()} false")


if __name__ == "__main__":
    main()
