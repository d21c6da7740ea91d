"""The k-mer spectrum of a short-read set: ``count_reads`` of the port, as
``hga-torch count`` runs it once the reads are loaded.

A job counts every read of one input set: canonical k-mer extraction in
batches of ``batch_reads``, one global count, the histogram, the valley
threshold and the solid set, returned to the host.  Its work is the bases
of the reads.  The comparison is exact: every job's histogram and distinct
total, and the whole solid set with its counts (so its threshold) of a
sample of jobs, against the plain spectrum (reference/spectrum.py) of
the same reads.  The control keys k-mers by 32 bits (``key_bits=32``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark import gen
from benchmark.reference import spectrum as ref_spectrum

# each number compared, with its limit (the comparison is exact); the
# threshold is held through the solid set, which the reference cuts at its
# own threshold
LIMITS = dict(hist_off=0, distinct_off=0, solid_off=0)


class Jobs:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: str):
        from hga_tpu_torch.config import AssemblerConfig
        from hga_tpu_torch.io.encode import PackedReads

        self.device = device
        self.spec = config["spectrum"]
        self.cfg = AssemblerConfig(
            k=self.spec["k"], max_count=self.spec["max_count"],
            solid_threshold=self.spec["solid_threshold"],
            batch_reads=config["batch_reads"])
        reads = config[mix["reads"]]
        circular = config["genome"]["circular"]
        self.n_inputs = mix["distinct_inputs"]
        self.reads = []
        for i in range(self.n_inputs):
            g = gen.genome(gen.rng_for(seed, 1, i), config["genome"])
            packed, bad, length = gen.short_reads(gen.rng_for(seed, 2, i), g,
                                                  reads, circular)
            n = len(length)
            self.reads.append(PackedReads(
                packed=packed, bad=bad, length=length,
                names=[f"sr_{r}" for r in range(n)],
                category=np.zeros(n, np.int32), pad_len=reads["pad_len"]))

    def job(self, i: int):
        from hga_tpu_torch.models.spectrum import count_reads

        return count_reads(self.reads[i], self.cfg, device=self.device)

    def work(self, i: int) -> float:
        return float(self.reads[i].length.sum(dtype=np.int64))

    def summary(self, res) -> Dict:
        return dict(hist=np.asarray(res.hist, np.int64),
                    distinct=res.n_distinct)

    def answer(self, res) -> Dict:
        keys = ((res.hi.astype(np.uint64) << np.uint64(32))
                | res.lo.astype(np.uint64))
        return dict(self.summary(res), keys=keys,
                    counts=res.count.astype(np.int64))

    def _plain(self, i: int, key_bits: int) -> Dict:
        pr = self.reads[i]
        return ref_spectrum.spectrum(
            pr.packed, pr.bad, pr.length, self.spec["k"],
            self.spec["max_count"], self.spec["solid_threshold"],
            device=self.device, key_bits=key_bits)

    def reference(self, i: int) -> Dict:
        return self._plain(i, 64)

    def control(self, i: int) -> Dict:
        return self._plain(i, 32)

    @staticmethod
    def compare(ans: Dict, ref: Dict) -> Dict[str, int]:
        hist, rh = ans["hist"], ref["hist"]
        n = max(len(hist), len(rh))
        off = dict(
            hist_off=int(np.count_nonzero(
                np.pad(hist, (0, n - len(hist)))
                != np.pad(rh, (0, n - len(rh))))),
            distinct_off=abs(ans["distinct"] - ref["distinct"]))
        if "keys" in ans:
            off["solid_off"] = ref_spectrum.solid_off(
                ans["keys"], ans["counts"], ref["keys"], ref["counts"])
        return off
