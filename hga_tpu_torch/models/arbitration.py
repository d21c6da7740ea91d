"""Copy arbitration: vote RAW long reads onto assembled contigs to snap
family-averaged repeat loci back to the correct copy (PyTorch port of
``hga_tpu.models.arbitration``).

Why it exists.  Correction and polish pileups anchor short reads through
rare seeds.  Inside a multi-kb repeat whose backbone was family-averaged —
every divergent site carrying the family's majority base — same-copy short
reads share no rare seed with the backbone, so the cross-copy majority keeps
outvoting the copy's own variant and the wrong island is stable under any
number of polish passes.  A raw long read is one molecule from ONE copy and
spans the repeat plus its unique flanks: its placement is decided by rare
flank anchors, and at each divergent site ~90% of its bases carry the copy's
own variant, so the column vote flips the island to the true copy.

Mechanism:

1. anchors: contig minimizers form a sorted index; raw-long-read minimizers
   query it.  Only contig-unique seeds whose combined frequency stays under
   max_seed_freq anchor; an anchor is RARE at single-locus frequency.
2. placement: one (read, contig, rel) group per read — the one with the
   most rare anchors (ties: most anchors); groups without a rare anchor or
   below min_shared_minimizers emit no votes.
3. chain + chunks: the placed anchors run through
   overlap_long._chain_representatives; consecutive representatives cut the
   read into <= CHUNK-base pieces whose diagonals follow indel drift, anchor
   deserts bridged by linear diagonal interpolation.
4. votes: the chunks become a pseudo short-read set; (chunk, contig, rel,
   chunk-local diagonal) feed correction.consensus_backbones(cands=...) —
   K2' on the card (Lq 400 at k 15: W 13) — with the depth floor
   arb_min_depth.

The placement and chunk tables are host numpy, copied operation for
operation from the reference (stable argsorts, float64 bincount weights,
numpy floor division of negative numerators).  The contigs are packed at
their length rounded up to 16: the reference's 512 KiB pad granule exists
for XLA compiles, and the output does not depend on the pad.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import (PackedReads, decode_bases, pack_reads,
                                     unpack_codes)
from hga_tpu_torch.models.overlap_long import (_argsort_keys,
                                               _chain_representatives)
from hga_tpu_torch.models.seeding import extract_seed_entries
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

CHUNK = 384          # max query bases per vote chunk (one DP row)

# wall-clock split of the last arbitrate_contigs call (pipeline stats)
LAST_TIMINGS: dict = {}


def _contig_pad(raw: int) -> int:
    """The contigs' pad: the longest contig rounded up to 16."""
    return ((max(raw, 16) + 15) // 16) * 16


def _place_long_reads(pr_long: PackedReads, pr_c: PackedReads,
                      cfg: AssemblerConfig, rare_cap: int, device="cuda"):
    """Anchors of every raw long read against the contig set, restricted
    to each read's single best rare-anchored (read, contig, rel) group.

    Returns (q, t, rel, pos_q, pos_t_oriented) host arrays (possibly
    empty), with pos_t oriented the find_candidates_cross way
    (rel==1 -> lb - k - pos)."""
    k = cfg.k
    ec = extract_seed_entries(pr_c, cfg, device=device)
    el = extract_seed_entries(pr_long, cfg, device=device)
    key_c = (ec.hi.astype(np.uint64) << 32) | ec.lo.astype(np.uint64)
    key_l = (el.hi.astype(np.uint64) << 32) | el.lo.astype(np.uint64)
    order = np.argsort(key_c, kind="stable")
    srt = key_c[order]
    S = srt.shape[0]
    slot = np.searchsorted(srt, key_l)
    hit = (slot < S) & (srt[np.clip(slot, 0, S - 1)] == key_l)
    rnew = np.ones(S, bool)
    if S:
        rnew[1:] = srt[1:] != srt[:-1]
    run_of = np.cumsum(rnew) - 1
    run_start = np.nonzero(rnew)[0]
    run_len = np.diff(np.append(run_start, S))
    run = run_of[np.clip(slot, 0, S - 1)]
    freq_c = np.where(hit, run_len[run], 0)
    # read-side occurrence of each read seed (combined-frequency mask)
    ol = np.argsort(key_l, kind="stable")
    sl_ = key_l[ol]
    lnew = np.ones(sl_.size, bool)
    if sl_.size:
        lnew[1:] = sl_[1:] != sl_[:-1]
    lrun = np.cumsum(lnew) - 1
    freq_l = np.empty(sl_.size, np.int64)
    if sl_.size:
        freq_l[ol] = np.bincount(lrun)[lrun]
    comb = freq_c + freq_l
    # contig-unique seeds only: a seed at two contig loci pins nothing, and
    # anchors into a contig's other repeat loci would poison the group's
    # representatives; repeat interiors are bridged by interpolation
    take = np.where(hit & (freq_c == 1) & (comb <= cfg.max_seed_freq), 1, 0)
    total = int(take.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.int32), z, z
    eidx = np.repeat(np.arange(take.shape[0]), take)
    within = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
    cslot = run_start[run[eidx]] + within
    q = el.read[eidx].astype(np.int64)
    t = ec.read[order][cslot].astype(np.int64)
    rel = (el.strand[eidx] != ec.strand[order][cslot]).astype(np.int32)
    pos_q = el.pos[eidx].astype(np.int64)
    pt = ec.pos[order][cslot].astype(np.int64)
    lb = pr_c.length[t].astype(np.int64)
    pos_t = np.where(rel == 1, lb - k - pt, pt)
    rare = comb[eidx] <= rare_cap

    # best (read, contig, rel) group per read: most rare anchors, then
    # most anchors; groups need >= min_shared anchors and >= 1 rare one
    o = _argsort_keys(rel, t, q)
    q, t, rel, pos_q, pos_t, rare = (x[o] for x in
                                     (q, t, rel, pos_q, pos_t, rare))
    gnew = np.ones(q.shape[0], bool)
    gnew[1:] = (q[1:] != q[:-1]) | (t[1:] != t[:-1]) | (rel[1:] != rel[:-1])
    gid = np.cumsum(gnew) - 1
    cnt = np.bincount(gid)
    rcnt = np.bincount(gid, weights=rare.astype(np.float64)).astype(np.int64)
    g_q = q[gnew]
    ok_g = (cnt >= cfg.min_shared_minimizers) & (rcnt >= 1)
    # rank groups of the same read by (-rare, -cnt); winner has rank 0
    og = _argsort_keys(cnt.max() - cnt, rcnt.max() - rcnt, g_q)
    first = np.ones(og.shape[0], bool)
    first[1:] = g_q[og][1:] != g_q[og][:-1]
    win = np.zeros(og.shape[0], bool)
    win[og] = first
    keep = (ok_g & win)[gid]
    n_reads = np.unique(q).size if q.size else 0
    n_placed = np.unique(q[keep]).size if keep.any() else 0
    log.info("arbitration: placed %d/%d long reads (%d anchors)",
             n_placed, n_reads, int(keep.sum()))
    return (q[keep], t[keep], rel[keep], pos_q[keep], pos_t[keep])


def _chunk_table(rq, rt, rrel, rpq, rpt, rgid, read_len, contig_len, k: int):
    """Cut each placed chain into <= CHUNK-base vote chunks.

    Returns (read, contig, rel, q0, q1, dd) with dd the chunk-local
    diagonal (find_candidates_cross convention).  As in the reference, the
    head, inner and tail segments overlap by k bases at each representative
    boundary, so those windows vote twice."""
    gnew = np.ones(rq.shape[0], bool)
    gnew[1:] = rgid[1:] != rgid[:-1]
    g_first = np.nonzero(gnew)[0]
    g_len = np.diff(np.append(g_first, rq.shape[0]))
    last = g_first + g_len - 1
    diag = rpq - rpt

    la = read_len[rq[g_first]]
    lb = contig_len[rt[g_first]]
    d_first = diag[g_first]
    d_last = diag[last]
    # extended span along the end diagonals, clipped by contig availability
    qs = np.maximum(0, d_first)
    qe = np.minimum(la, lb + d_last)

    # piecewise segments: (q_from, q_to, d_from, d_to) per rep interval
    prev = np.arange(rq.shape[0]) - 1
    inner = ~gnew
    segs = []
    pid_of = np.cumsum(gnew) - 1
    # head: [qs, first_rep + k) at constant d_first
    segs.append((pid_of[g_first], qs, rpq[g_first] + k, d_first, d_first))
    # inner: [rep_prev, rep_cur + k) with diagonal interpolated prev->cur
    if inner.any():
        segs.append((pid_of[inner], rpq[prev[inner]], rpq[inner] + k,
                     diag[prev[inner]], diag[inner]))
    # tail: [last_rep, qe) at constant d_last
    segs.append((pid_of[last], rpq[last], qe, d_last, d_last))

    pid = np.concatenate([s[0] for s in segs])
    a0 = np.concatenate([s[1] for s in segs])
    a1 = np.concatenate([s[2] for s in segs])
    d0 = np.concatenate([s[3] for s in segs])
    d1 = np.concatenate([s[4] for s in segs])
    ok = a1 > a0
    pid, a0, a1, d0, d1 = (x[ok] for x in (pid, a0, a1, d0, d1))

    # split every segment into <= CHUNK-base chunks, diagonal interpolated
    span = a1 - a0
    n_sub = np.maximum(1, -(-span // CHUNK))
    tot = int(n_sub.sum())
    ridx = np.repeat(np.arange(pid.shape[0]), n_sub)
    j = np.arange(tot) - np.repeat(np.cumsum(n_sub) - n_sub, n_sub)
    nsr = n_sub[ridx]
    qa = a0[ridx] + (span[ridx] * j) // nsr
    qb = a0[ridx] + (span[ridx] * (j + 1)) // nsr
    # diagonal at the chunk start, linearly interpolated over the segment
    # (numpy floor division: the numerator may be negative)
    num = (d1[ridx] - d0[ridx]) * (qa - a0[ridx])
    dd_at = d0[ridx] + np.where(span[ridx] > 0,
                                num // np.maximum(span[ridx], 1), 0)
    pidx = pid[ridx]
    read = rq[g_first][pidx]
    contig = rt[g_first][pidx]
    rel = rrel[g_first][pidx]
    # chunk-local: the chunk's forward frame starts at qa
    dd = dd_at - qa
    return read, contig, rel, qa, qb, dd


def arbitrate_contigs(
    contigs: List[Tuple[str, str]],
    pr_long: PackedReads,
    cfg: AssemblerConfig,
    rare_cap: int = 0,
    device="cuda",
    mesh=None,
) -> List[Tuple[str, str]]:
    """Arbitrate every contig with the raw long reads on `device` (``"cuda"``
    unless the caller asks for ``"cpu"``); returns the arbitrated (name,
    sequence) list in order.  No-op on empty inputs.  On a mesh of several
    ranks every rank places the reads, and each batch's votes are split
    over the ranks and summed (correction.consensus_backbones).

    rare_cap 0 = auto: ~1.6x the long-read coverage estimated from total
    long bases over total contig bases, +2 — a unique-locus seed occurs
    ~coverage times on the read side + once on the contig side, while a
    seed shared by even two repeat copies occurs at ~2x that."""
    if not contigs or pr_long.n_reads == 0:
        return contigs
    from hga_tpu_torch.models.correction import consensus_backbones

    dev = resolve_device(device)
    with spans.span("arbitration.place") as sp_place:
        seqs = [s for _, s in contigs]
        pr_c = pack_reads(seqs, names=[n for n, _ in contigs],
                          category=np.ones(len(seqs), np.int32),
                          pad_len=_contig_pad(max(len(s) for s in seqs)))
        if rare_cap <= 0:
            cov_l = float(pr_long.length.sum()) / max(1, sum(map(len, seqs)))
            rare_cap = max(6, int(1.6 * cov_l) + 2)
        q, t, rel, pos_q, pos_t = _place_long_reads(pr_long, pr_c, cfg,
                                                    rare_cap, device=dev)
        if q.size == 0:
            log.info("arbitration: no placeable long reads — contigs "
                     "unchanged")
            return contigs
        rq, rt, rrel, rpq, rpt, rgid, _ = _chain_representatives(
            q, t, rel, pos_q, pos_t, cfg.min_shared_minimizers)
        if rq.size == 0:
            return contigs
        read, contig, crel, qa, qb, dd = _chunk_table(
            rq, rt, rrel, rpq, rpt, rgid,
            pr_long.length.astype(np.int64), pr_c.length.astype(np.int64),
            cfg.k)

    # drop degenerate chunks (shorter than a seed — nothing to vote)
    keep_c = (qb - qa) >= max(32, cfg.k)
    read, contig, crel, qa, qb, dd = (x[keep_c] for x in
                                      (read, contig, crel, qa, qb, dd))
    if read.size == 0:
        return contigs

    # materialize chunk reads (host; raw codes sliced from the long plane
    # via FLAT indexing — a codes[read] row gather would materialize
    # (n_chunks, Lpad) for nothing)
    with spans.span("arbitration.mat") as sp_mat:
        codes = unpack_codes(pr_long.packed)
        Lp = codes.shape[1]
        flat = codes.reshape(-1)
        clen = (qb - qa).astype(np.int64)
        pad_k = ((CHUNK + cfg.k + 15) // 16) * 16
        xs = np.arange(pad_k)[None, :]
        gidx = read[:, None] * Lp + np.clip(xs + qa[:, None], 0, Lp - 1)
        win = np.where(xs < clen[:, None], flat[gidx], 0).astype(np.uint8)
        chunk_seqs = [decode_bases(win[i, :clen[i]])
                      for i in range(win.shape[0])]
        pr_chunks = pack_reads(chunk_seqs, pad_len=pad_k)

    with spans.span("arbitration.vote") as sp_vote:
        cands = (np.arange(len(chunk_seqs), dtype=np.int32),
                 contig.astype(np.int32), crel.astype(np.int32),
                 dd.astype(np.int32))
        arb_cfg = cfg.replace(min_pileup_depth=cfg.arb_min_depth)
        out = consensus_backbones(pr_c, pr_chunks, arb_cfg, device=dev,
                                  cands=cands, mesh=mesh)
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(place_s=round(sp_place.seconds, 3),
                        mat_s=round(sp_mat.seconds, 3),
                        vote_s=round(sp_vote.seconds, 3),
                        n_chunks=len(chunk_seqs),
                        rare_cap=rare_cap)
    log.info("arbitration: %s", LAST_TIMINGS)
    return [(n, s) for (n, _), s in zip(contigs, out)]
