"""Stage 1 (judged config 1) — k-mer counting + spectrum histogram (PyTorch).

Counterpart of ``hga_tpu.models.spectrum``.  One device: packed read
batches -> device k-mer extraction (ops.kmer) -> ONE global device sort and
segment sum over int64 keys (ops.count) -> histogram -> valley threshold ->
solid k-mer set; only the histogram and the solid set come back to host.

On a mesh of several ranks (parallel/): each batch is split over the ranks
and counted by owner shard (parallel/collectives.count_kmers_bucketed: one
all_to_all routes each k-mer to the rank owning its hash), the shards'
disjoint compact segments are gathered in shard order, and one final sort
counts them.  That result keeps the FULL distinct set, as the reference's
mesh path does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import PackedReads
from hga_tpu_torch.ops import count as C
from hga_tpu_torch.ops import kmer as K
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.device import resolve_device
from hga_tpu_torch.utils.oracle import solid_threshold_from_hist

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SpectrumResult:
    """Host-side result of the counting stage (same fields and artifact as
    ``hga_tpu.models.spectrum.SpectrumResult``).  hi/lo/count hold the SOLID
    k-mers; `distinct` carries the true distinct total."""

    hi: np.ndarray        # uint32[n] canonical k-mers (sorted)
    lo: np.ndarray        # uint32[n]
    count: np.ndarray     # int32[n]
    hist: np.ndarray      # int32[max_count+1]
    threshold: int        # chosen solid threshold
    k: int
    distinct: int = -1    # total distinct k-mers (-1: same as hi.size)

    @property
    def n_distinct(self) -> int:
        return int(self.distinct) if self.distinct >= 0 else int(self.hi.shape[0])

    def solid_set(self) -> Tuple[np.ndarray, np.ndarray]:
        m = self.count >= self.threshold
        return self.hi[m], self.lo[m]

    def save(self, path: str) -> None:
        np.savez_compressed(path, hi=self.hi, lo=self.lo, count=self.count,
                            hist=self.hist, threshold=np.int64(self.threshold),
                            k=np.int64(self.k),
                            distinct=np.int64(self.n_distinct))

    @staticmethod
    def load(path: str) -> "SpectrumResult":
        from hga_tpu_torch.convert import load_spectrum

        return load_spectrum(path)


def _batch_keys(pr: PackedReads, sel: np.ndarray, k: int,
                device: torch.device) -> torch.Tensor:
    """Canonical k-mer keys of reads `sel` (invalid slots = sentinel key)."""
    with spans.span("spectrum.batch_prep"):
        packed = np.ascontiguousarray(pr.packed[sel], dtype=np.uint32)
        bad = np.ascontiguousarray(pr.bad[sel], dtype=np.uint32)
        length = np.ascontiguousarray(pr.length[sel])
    with spans.span("spectrum.h2d"):
        args = (K.words_to_tensor(packed, device),
                K.words_to_tensor(bad, device),
                torch.from_numpy(length).to(device))
    spans.count("spectrum.h2d_bytes", packed.nbytes + bad.nbytes
                + length.nbytes)
    with spans.span("spectrum.extract"):
        return K.kmer_keys(*args, k)


def count_reads(
    pr: PackedReads,
    cfg: AssemblerConfig,
    category: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> SpectrumResult:
    """Count canonical k-mers of (a category of) a read set; pick threshold.

    Extraction runs batch-wise (cfg.batch_reads reads) on `device`; one
    global sort counts every batch's keys at once.  With a mesh of several
    ranks, owner-shard counting (see the module docstring).
    """
    with spans.span("spectrum.count_reads"):
        spans.count("spectrum.calls")
        dev = resolve_device(device)
        with spans.span("spectrum.batch_prep"):     # the rows to count
            idx = np.arange(pr.n_reads)
            if category is not None:
                idx = idx[pr.category == category]
        if mesh is not None and mesh.size > 1:
            return _count_reads_mesh(idx, pr, cfg, dev, mesh)
        return _count_reads(idx, pr, cfg, dev)


def _count_reads(idx: np.ndarray, pr: PackedReads, cfg: AssemblerConfig,
                 dev: torch.device) -> SpectrumResult:
    """count_reads of the reads `idx` on one device."""
    B = cfg.batch_reads
    parts = [_batch_keys(pr, idx[s:s + B], cfg.k, dev)
             for s in range(0, len(idx), B)]
    if not parts:
        hist = np.zeros(cfg.max_count + 1, np.int64)
        thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
        z = np.zeros(0, np.uint32)
        return SpectrumResult(hi=z, lo=z.copy(), count=np.zeros(0, np.int32),
                              hist=hist, threshold=int(thr), k=cfg.k,
                              distinct=0)
    with spans.span("spectrum.count"):
        key = torch.cat(parts)
        del parts
        keys, counts = C.count_keys(key, torch.ones_like(key))
        del key
    distinct = int(keys.shape[0])
    with spans.span("spectrum.hist"):
        c = torch.clamp(counts, 0, cfg.max_count)
        hist = torch.bincount(c, minlength=cfg.max_count + 1).to(
            torch.int32).cpu().numpy()
        thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
    with spans.span("spectrum.solid_out"):
        solid = counts >= thr
        hi, lo = C.unpack_key(keys[solid])
        cnt = counts[solid].to(torch.int32)
        # host metadata: no synchronisation
        spans.count("spectrum.d2h_bytes",
                    hist.nbytes + hi.nbytes + lo.nbytes + cnt.nbytes)
        hi = hi.cpu().numpy().astype(np.uint32)
        lo = lo.cpu().numpy().astype(np.uint32)
        cnt = cnt.cpu().numpy()
    log.info("spectrum: %d distinct %d-mers (%d solid), threshold=%d",
             distinct, cfg.k, hi.size, thr)
    return SpectrumResult(hi=hi, lo=lo, count=cnt, hist=hist,
                          threshold=int(thr), k=cfg.k, distinct=distinct)


def _count_reads_mesh(idx: np.ndarray, pr: PackedReads, cfg: AssemblerConfig,
                      dev: torch.device, mesh) -> SpectrumResult:
    """count_reads on a mesh: every batch (padded to a multiple of P reads)
    is split over the ranks and counted by owner shard; the lanes hold 2x
    the uniform share, and a batch whose lanes overflowed is counted once
    more at the worst case (every k-mer to one owner)."""
    from hga_tpu_torch.parallel import collectives as PC
    from hga_tpu_torch.parallel import hostpart as HP
    from hga_tpu_torch.parallel.mesh import pad_to_multiple

    P = mesh.size
    B = pad_to_multiple(cfg.batch_reads, P)
    nb = B // P
    kmers_per_read = pr.pad_len - cfg.k + 1
    bucket_cap = 2 * nb * kmers_per_read // P + 1024
    worst_cap = nb * kmers_per_read
    parts = []
    for s in range(0, len(idx), B):
        sel = idx[s:s + B]
        packed, bad, length = pr.packed[sel], pr.bad[sel], pr.length[sel]
        if packed.shape[0] < B:  # the tail batch, zero-length reads
            pad = B - packed.shape[0]
            packed = np.pad(packed, ((0, pad), (0, 0)))
            bad = np.pad(bad, ((0, pad), (0, 0)))
            length = np.pad(length, (0, pad))
        mine = slice(mesh.rank * nb, (mesh.rank + 1) * nb)
        ship = (packed[mine], bad[mine], length[mine])
        spans.count("spectrum.h2d_bytes", sum(x.nbytes for x in ship))
        args = (K.words_to_tensor(ship[0], dev),
                K.words_to_tensor(ship[1], dev),
                torch.from_numpy(ship[2]).to(dev))
        ck, overflow = PC.count_kmers_bucketed(mesh, *args, cfg.k, bucket_cap)
        if overflow > 0:
            log.info("spectrum: bucket overflow, retrying at worst case")
            ck, _ = PC.count_kmers_bucketed(mesh, *args, cfg.k, worst_cap)
        # this shard's compact segment; shards in order, as the reference
        # concatenates [s * seg, s * seg + n_s) over s
        part = {"hi": HP.fetch(ck.hi[:ck.n]), "lo": HP.fetch(ck.lo[:ck.n]),
                "count": HP.fetch(ck.count[:ck.n])}
        spans.count("spectrum.d2h_bytes",
                    sum(x.nbytes for x in part.values()))
        parts.append(HP.allgather_concat(part))
    if parts:
        cat = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
        spans.count("spectrum.h2d_bytes", sum(x.nbytes for x in cat.values()))
        merged = C.sort_and_count(*(torch.from_numpy(cat[f]).to(dev)
                                    for f in ("hi", "lo", "count")))
        hist = C.spectrum_histogram(merged, cfg.max_count).cpu().numpy()
        n = merged.n
        hi = merged.hi[:n].cpu().numpy().astype(np.uint32)
        lo = merged.lo[:n].cpu().numpy().astype(np.uint32)
        cnt = merged.count[:n].cpu().numpy()
        spans.count("spectrum.d2h_bytes", hist.nbytes + cnt.nbytes
                    + merged.hi[:n].nbytes + merged.lo[:n].nbytes)
    else:
        hist = np.zeros(cfg.max_count + 1, np.int64)
        hi = np.zeros(0, np.uint32)
        lo = np.zeros(0, np.uint32)
        cnt = np.zeros(0, np.int32)
    thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
    log.info("spectrum: %d distinct %d-mers, threshold=%d", hi.size, cfg.k,
             thr)
    return SpectrumResult(hi=hi, lo=lo, count=cnt, hist=hist,
                          threshold=int(thr), k=cfg.k)
