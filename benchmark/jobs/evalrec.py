"""Placement-free evaluation of a finished assembly of a genome of several
records (a chromosome and its plasmids) against the reference's records:
``segment_identity`` of the port on one card, as ``hga-torch eval --segs``
runs it on a multi-record reference.

A job cuts each contig into ``seg``-base segments and finds each one's
best semi-global edit distance anywhere in any record, on either strand, a
circular record read across its origin (K1''s shared-target mode on the
records' row, ``batch`` segments a launch), and sums them into one
identity.  Its work is the contigs' bases.  The comparison is exact: every
job's summed distance and identity against the plain segment distances of
the same contigs and records (reference/segdist_records.py).  The control
joins the records into one linear sequence, with no separator or wrap, as
a reference read as one string was judged.
"""

from __future__ import annotations

from typing import Dict

from benchmark import gen, gen_records
from benchmark.reference import segdist_records

# each number compared, with its limit (the comparison is exact); the
# segment count is held through the summed distance
LIMITS = dict(dist_off=0, identity_off=0.0)


class Jobs:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        self.device = device
        self.seg, self.batch = mix["seg"], mix["batch"]
        self.n_inputs = mix["distinct_inputs"]
        self.records, self.contigs, self.text = [], [], []
        for i in range(self.n_inputs):
            recs = gen_records.genome(gen.rng_for(seed, 1, i),
                                      config["genome"])
            cs = gen_records.assembly(gen.rng_for(seed, 3, i), recs,
                                      mix["assembly"])
            self.records.append([(g, circ) for _, g, circ in recs])
            self.contigs.append(cs)
            self.text.append((
                [(f"contig_{j + 1}", gen.decode(c)) for j, c in enumerate(cs)],
                [(name, gen.decode(g), circ) for name, g, circ in recs]))

    def job(self, i: int):
        from hga_tpu_torch.utils.evalx import segment_identity

        contigs, records = self.text[i]
        return segment_identity(contigs, records, seg=self.seg,
                                batch=self.batch, device=self.device)

    def work(self, i: int) -> float:
        return float(sum(len(c) for c in self.contigs[i]))

    def shapes(self, i: int) -> Dict:
        return dict(
            segments=sum(-(-len(c) // self.seg) for c in self.contigs[i]),
            seg=self.seg,
            target_cols=segdist_records.row_columns(
                [(len(g), circ) for g, circ in self.records[i]], self.seg))

    def summary(self, res) -> Dict:
        return dict(dist=int(res["segment_dist"]),
                    identity=float(res["segment_identity"]))

    answer = summary

    def _plain(self, i: int, dists) -> Dict:
        span = sum(len(c) for c in self.contigs[i])
        total = int(dists.sum())
        return dict(dist=total, identity=1.0 - total / max(span, 1))

    def reference(self, i: int) -> Dict:
        return self._plain(i, segdist_records.segment_distances(
            self.records[i], self.contigs[i], self.seg, device=self.device))

    def control(self, i: int) -> Dict:
        return self._plain(i, segdist_records.joined_distances(
            self.records[i], self.contigs[i], self.seg, device=self.device))

    @staticmethod
    def compare(ans: Dict, ref: Dict) -> Dict[str, float]:
        return dict(dist_off=abs(ans["dist"] - ref["dist"]),
                    identity_off=abs(ans["identity"] - ref["identity"]))
