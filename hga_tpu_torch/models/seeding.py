"""Stage 2 — minimizer seed entries and solid-seed masking (PyTorch).

Counterpart of the parts of ``hga_tpu.models.seeding`` that the hybrid main
path runs: ``extract_seed_entries`` (device minimizer selection + compaction)
and ``solid_mask``.  Candidate generation on this path goes through the
sorted-index routes in models/overlap_long.py.
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
from hga_tpu_torch.ops.count import member_sorted
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# device minimizer-plane slots (reads x windows) per extraction batch: the
# batch row count scales down for long pads so memory stays bounded
EXTRACT_SLOT_BUDGET = 1 << 24


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
