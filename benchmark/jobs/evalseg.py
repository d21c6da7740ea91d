"""Placement-free evaluation of a finished assembly against its reference:
``segment_identity`` of the port on one card, as ``hga-torch eval --segs``
runs it.

A job cuts the contig into ``seg``-base segments and finds each one's best
semi-global edit distance anywhere in the reference and its reverse
complement (K1''s shared-target mode, ``batch`` segments a launch), and
sums them into one identity.  Its work is the contig's bases.  The
comparison is exact: every job's summed distance and identity against
the plain segment distances (reference/segdist.py) of the same contig and
genome.  The control places each segment by its first
seed hit (``placement="seed"``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark import gen
from benchmark.reference import segdist

# each number compared, with its limit (the comparison is exact); the
# segment count is held through the summed distance
LIMITS = dict(dist_off=0, identity_off=0.0)


class Jobs:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        self.device = device
        self.seg, self.batch = mix["seg"], mix["batch"]
        circular = config["genome"]["circular"]
        self.n_inputs = mix["distinct_inputs"]
        self.genomes, self.contigs, self.text = [], [], []
        for i in range(self.n_inputs):
            g = gen.genome(gen.rng_for(seed, 1, i), config["genome"])
            c = gen.assembly(gen.rng_for(seed, 3, i), g, mix["assembly"],
                             circular)
            self.genomes.append(g)
            self.contigs.append(c)
            self.text.append(([("contig_1", gen.decode(c))], gen.decode(g)))

    def job(self, i: int):
        from hga_tpu_torch.utils.evalx import segment_identity

        contigs, reference = self.text[i]
        return segment_identity(contigs, reference, seg=self.seg,
                                batch=self.batch, device=self.device)

    def work(self, i: int) -> float:
        return float(len(self.contigs[i]))

    def shapes(self, i: int) -> Dict:
        return dict(segments=-(-len(self.contigs[i]) // self.seg),
                    seg=self.seg, target_cols=2 * len(self.genomes[i]) + 1)

    def summary(self, res) -> Dict:
        return dict(dist=int(res["segment_dist"]),
                    identity=float(res["segment_identity"]))

    answer = summary

    def _plain(self, i: int, placement: str) -> Dict:
        d = segdist.segment_distances(self.genomes[i], self.contigs[i],
                                      self.seg, device=self.device,
                                      placement=placement)
        span = len(self.contigs[i])
        total = int(d.sum())
        return dict(dist=total, identity=1.0 - total / max(span, 1))

    def reference(self, i: int) -> Dict:
        return self._plain(i, "free")

    def control(self, i: int) -> Dict:
        return self._plain(i, "seed")

    @staticmethod
    def compare(ans: Dict, ref: Dict) -> Dict[str, float]:
        return dict(dist_off=abs(ans["dist"] - ref["dist"]),
                    identity_off=abs(ans["identity"] - ref["identity"]))
