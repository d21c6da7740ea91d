"""Stage 2 (judged config 2) — minimizer seeding + candidate overlap pairs
(PyTorch port of ``hga_tpu.models.seeding``).

Packed reads -> device minimizer selection (ops/minimizer.py) -> flat
(minimizer, read, pos, strand) entries (``extract_seed_entries``) ->
optional solid-seed mask (``solid_mask``) -> candidate pairs
(``find_candidates``): the sorted self-join of ops/pairs.py, or above
INDEXED_ROUTE_ENTRIES entries the chunked sorted-index route of
models/overlap_long.py.  ``SeedingResult`` is the ``candidates.npz``
artifact, byte-compatible with the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import PackedReads
from hga_tpu_torch.ops import kmer as K
from hga_tpu_torch.ops import minimizer as M
from hga_tpu_torch.ops.count import SENTINEL, member_sorted
from hga_tpu_torch.ops.pairs import candidate_pairs
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# device minimizer-plane slots (reads x windows) per extraction batch: the
# batch row count scales down for long pads so memory stays bounded
EXTRACT_SLOT_BUDGET = 1 << 24


@dataclasses.dataclass
class SeedingResult:
    a: np.ndarray
    b: np.ndarray
    rel: np.ndarray
    diag: np.ndarray
    shared: np.ndarray
    overflow: int

    @property
    def n_pairs(self) -> int:
        return int(self.a.shape[0])

    def save(self, path: str) -> None:
        np.savez_compressed(path, a=self.a, b=self.b, rel=self.rel,
                            diag=self.diag, shared=self.shared,
                            overflow=np.int64(self.overflow))


@dataclasses.dataclass
class SeedEntries:
    """Flat host-side minimizer entries for a read set."""

    hi: np.ndarray
    lo: np.ndarray
    read: np.ndarray
    pos: np.ndarray
    strand: np.ndarray


def solid_mask(hi: np.ndarray, lo: np.ndarray, solid, device="cuda"
               ) -> np.ndarray:
    """Membership of seed k-mers in the solid set (device binary search)."""
    dev = resolve_device(device)
    s_hi, s_lo = solid
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(dev)
    return member_sorted(t(s_hi), t(s_lo), t(hi), t(lo)).cpu().numpy()


def drop_unsolid(hi: np.ndarray, lo: np.ndarray, solid, cfg: AssemblerConfig,
                 device, what: str):
    """(hi, lo) with every seed whose k-mer is not solid set to SENTINEL, so
    it makes no pair; unchanged without a solid set or with
    cfg.use_solid_seeds off."""
    if solid is None or not cfg.use_solid_seeds:
        return hi, lo
    keep = solid_mask(hi, lo, solid, device=device)
    log.info("%s: %d/%d seeds are solid", what, int(keep.sum()), keep.size)
    return (np.where(keep, hi, np.uint32(SENTINEL)),
            np.where(keep, lo, np.uint32(SENTINEL)))


def extract_seed_entries(pr: PackedReads, cfg: AssemblerConfig,
                         idx: Optional[np.ndarray] = None,
                         device="cuda") -> SeedEntries:
    """Device minimizer selection + compaction, batch-wise.

    Entries come out read-major, window order within a read — the order
    of the reference's cumsum compaction.
    """
    dev = resolve_device(device)
    if idx is None:
        idx = np.arange(pr.n_reads)
    B = max(1, min(cfg.batch_reads, EXTRACT_SLOT_BUDGET // max(pr.pad_len, 1)))
    log.info("seeding: extracting minimizers for %d reads (batch %d)",
             len(idx), B)
    his, los, reads, poss, strands = [], [], [], [], []
    for s in range(0, len(idx), B):
        sel = idx[s:s + B]
        length = torch.from_numpy(pr.length[sel]).to(dev)
        kb = K.extract_kmers(K.words_to_tensor(pr.packed[sel], dev),
                             K.words_to_tensor(pr.bad[sel], dev), length,
                             cfg.k)
        mb = M.select_minimizers(kb, cfg.w, length, cfg.k)
        rows, cols = torch.nonzero(mb.take, as_tuple=True)
        if rows.numel() == 0:
            continue
        his.append(mb.hi[rows, cols].cpu().numpy())
        los.append(mb.lo[rows, cols].cpu().numpy())
        poss.append(mb.pos[rows, cols].cpu().numpy())
        strands.append(mb.strand[rows, cols].cpu().numpy())
        reads.append(sel[rows.cpu().numpy()])
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    return SeedEntries(
        hi=cat(his, np.uint32), lo=cat(los, np.uint32),
        read=cat(reads, np.int32), pos=cat(poss, np.int32),
        strand=cat(strands, np.int32),
    )


def find_candidates(
    pr: PackedReads,
    cfg: AssemblerConfig,
    mode: str = "all",
    idx: Optional[np.ndarray] = None,
    pair_cap: Optional[int] = None,
    solid=None,
    device="cuda",
) -> SeedingResult:
    """Config-2 stage: minimizers -> frequency-filtered candidate pairs.

    solid: optional (hi, lo) solid-k-mer arrays; seeds whose k-mer is not
    solid are dropped before pair generation.  Above INDEXED_ROUTE_ENTRIES
    estimated entries all-vs-all goes through the chunked sorted-index route
    (models/overlap_long.find_candidates_all_indexed, same pair semantics).
    pair_cap only selects the route, as in the reference: the self-join
    returns every kept pair, so overflow is always 0.
    """
    from hga_tpu_torch.models import overlap_long as OL

    dev = resolve_device(device)
    if mode == "all" and idx is None and pair_cap is None:
        est = 2 * int(pr.length.sum()) // max(cfg.w, 1)
        if est > OL.INDEXED_ROUTE_ENTRIES:
            return OL.find_candidates_all_indexed(pr, cfg, solid=solid,
                                                  device=dev)
    ent = extract_seed_entries(pr, cfg, idx, device=dev)
    hi, lo = drop_unsolid(ent.hi, ent.lo, solid, cfg, dev, "seeding")
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(dev)
    cp = candidate_pairs(t(hi), t(lo), t(ent.read), t(ent.pos),
                         t(ent.strand), t(pr.length), t(pr.category),
                         k=cfg.k, max_freq=cfg.max_seed_freq,
                         min_shared=cfg.min_shared_minimizers, mode=mode)
    host = lambda x: x.cpu().numpy()
    res = SeedingResult(a=host(cp.a), b=host(cp.b), rel=host(cp.rel),
                        diag=host(cp.diag), shared=host(cp.shared),
                        overflow=0)
    log.info("seeding: %d entries -> %d candidate pairs",
             ent.hi.shape[0], res.n_pairs)
    return res
