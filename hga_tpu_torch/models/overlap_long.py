"""Long-vs-long overlap engine: minimizer anchors -> colinear chain ->
per-segment bit-parallel DP (PyTorch port of ``hga_tpu.models.overlap_long``).

1. **Anchors** — the sorted minimizer index is queried per read-chunk; each
   shared minimizer yields an anchor (q, t, rel, pos_q, pos_t), expanded
   with vectorized run arithmetic (host numpy, copied from the reference).
2. **Chain** — anchors of a pair are bucketed along the query axis
   (SEG-sized buckets); each bucket's representative is its diagonal-median
   anchor, an outlier-robust piecewise chain that follows indel drift.
3. **Segments** — consecutive representatives cut the alignment into
   bounded query spans; every segment becomes one row of a batched
   bit-parallel Myers call (K1, ops/myers_cuda.py, on the card) against an
   exactly positioned target window gathered on the device from the resident
   packed reads.  End segments run with free target ends (the first one on
   reversed sequences) so the overlap's target coordinates come out of the
   DP exactly; middle segments contribute edit distance.
4. **Aggregate** — per-pair distance = sum over segments; identity gate
   dist <= (1 - min_identity) * span; PAF-shaped OverlapRecords out.

Each DP batch is read back right after its launch; the reference's depth-8
in-flight queue existed to hide a tunnel round trip this port does not have.
The sorted-index candidate routes (``find_candidates_cross_indexed`` for
correction/polish and config 3, ``find_candidates_all_indexed`` for
all-vs-all above INDEXED_ROUTE_ENTRIES) live here too, as in the reference.

In a world of several ranks (parallel/), ``compute_overlaps_long`` and
``find_candidates_all_indexed`` split their query reads into contiguous
rank blocks and gather the results back in rank order, which is the
one-process order.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import PackedReads
from hga_tpu_torch.models.overlap import OverlapRecords, SENT_BASE, default_edit
from hga_tpu_torch.models.seeding import (SeedingResult, extract_seed_entries,
                                         solid_mask)
from hga_tpu_torch.ops.kmer import words_to_tensor
from hga_tpu_torch.parallel import hostpart as HP
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# wall-clock split of the last compute_overlaps_long run (same keys as the
# reference): index_s, anchor_s, chain_s, segprep_s, dp_s (device dispatch
# incl. per-batch readback), n_anchors, n_pairs, n_segments, bytes_up
LAST_TIMINGS: Dict[str, float] = {}

SEG = 384          # query bases per segment (Lq_seg = 414 = 14 Myers words)
SLACK = 32         # target window slack beyond the anchored span, per side

# above this many combined minimizer entries the reference switches to the
# chunked sorted-index routes; the correction path always passes an index
INDEXED_ROUTE_ENTRIES = 3_000_000

def _argsort_keys(*keys: np.ndarray) -> np.ndarray:
    """`np.lexsort(keys)` (minor-to-major key order) as ONE composite-uint64
    radix argsort when the combined bit budget fits.

    The global candidate expansion lexsorts millions of anchors per chunk —
    the round-4 correction stage's named host hot spot (ROADMAP).  A single
    stable argsort over a packed key measured 2.5x faster than the 4-key
    lexsort at 8M rows with an identical permutation (both sorts are stable,
    so ties keep original order either way).  Falls back to np.lexsort when
    the ranges cannot pack into 63 bits.
    """
    n = keys[0].shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    mins, widths, total = [], [], 0
    for kk in keys:
        mn = int(kk.min())
        w = max(1, int(int(kk.max()) - mn).bit_length())
        mins.append(mn)
        widths.append(w)
        total += w
    if total > 63:
        return np.lexsort(keys)
    key = np.zeros(n, np.uint64)
    shift = 0
    for kk, mn, w in zip(keys, mins, widths):
        key |= (kk.astype(np.int64) - mn).astype(np.uint64) << np.uint64(shift)
        shift += w
    return np.argsort(key, kind="stable")



@dataclasses.dataclass
class SeedIndex:
    """Host-side sorted minimizer index over one read set (SURVEY.md C6).

    The reference keeps a hash-map seed index; at judged scale the bounded
    device self-join would materialize O(N * max_freq) pair slots at once
    (ROADMAP round-1 limit), so candidate GENERATION streams through this
    sorted index in read-aligned chunks while all DP stays on device.
    """

    srt_key: np.ndarray     # uint64 (hi<<32|lo), sorted
    srt_read: np.ndarray
    srt_pos: np.ndarray
    srt_strand: np.ndarray
    run_start: np.ndarray   # first sorted slot of each distinct k-mer
    run_len: np.ndarray
    run_of_slot: np.ndarray



def build_seed_index(pr: PackedReads, cfg: AssemblerConfig,
                     solid=None, device="cuda") -> SeedIndex:
    ent = extract_seed_entries(pr, cfg, device=device)
    hi, lo = ent.hi, ent.lo
    keepm = None
    if solid is not None and cfg.use_solid_seeds:
        keepm = solid_mask(hi, lo, solid, device=device)
        log.info("index: %d/%d seeds are solid", int(keepm.sum()), keepm.size)
    key = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    if keepm is not None:
        key = key[keepm]
        ent = type(ent)(hi=hi[keepm], lo=lo[keepm], read=ent.read[keepm],
                        pos=ent.pos[keepm], strand=ent.strand[keepm])
    order = np.argsort(key, kind="stable")
    srt_key = key[order]
    rnew = np.ones(srt_key.shape[0], bool)
    rnew[1:] = srt_key[1:] != srt_key[:-1]
    run_start = np.nonzero(rnew)[0]
    run_len = np.diff(np.append(run_start, srt_key.shape[0]))
    return SeedIndex(
        srt_key=srt_key, srt_read=ent.read[order], srt_pos=ent.pos[order],
        srt_strand=ent.strand[order], run_start=run_start, run_len=run_len,
        run_of_slot=np.cumsum(rnew) - 1)


def find_candidates_cross_indexed(
    pr_a: PackedReads,          # short reads (index side)
    pr_b: PackedReads,          # backbones (query side)
    cfg: AssemblerConfig,
    solid=None,
    index: Optional[SeedIndex] = None,
    chunk_reads: int = 256,
    depth_cap: int = 0,
    rare_cap: int = 0,
    anchor_min: int = 2,
    device="cuda",
    b_mine: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Scalable cross candidates (same output contract as
    models.correction.find_candidates_cross): sorted short-read index,
    backbone reads streamed in chunks, per-(a, b, rel) aggregation to a
    median diagonal — memory bounded by the chunk, not the read set.

    depth_cap > 0 keeps at most depth_cap pairs per (backbone, ~read-length
    position bucket), highest shared-seed counts first: a pileup only needs
    bounded depth, and at coverage 30 x 20 the uncapped candidate count is
    what dominates judged-scale wall clock.  The cap is POSITIONAL — a global
    per-backbone top-N clusters its picks and leaves pileup holes
    elsewhere on a multi-kb backbone (measured: cap 12 polished a 40 kb
    backbone to 0.93 k-mer identity; the positional cap reaches 1.0000).

    rare_cap > 0 enables COPY-AWARE candidate filtering, the repeat-
    resolution mechanism (ROADMAP round-4: correction family-averaged
    repeat copies).  A candidate is ANCHORED when >= 1 of its shared seeds
    has combined occurrence <= rare_cap (single-locus frequency: the seed
    pins the read to one genome locus — a copy-distinguishing flank or a
    k-mer over a copy's own divergent site).  Seeds shared by 2-3 repeat
    copies slip under max_seed_freq (7-copy family seeds are masked, but a
    k-mer on which only 2 copies agree occurs at ~2x coverage) and connect
    reads CROSS-copy; such candidates carry no rare seed.  The filter
    drops ambiguous (un-anchored) candidates exactly where anchored depth
    exists (>= anchor_min anchored candidates in the same positional
    bucket): at every copy-distinguishing position, same-copy reads are
    anchored there by the divergent site itself, so the cross-copy votes
    that would average the family are dropped; in locally-identical
    stretches no anchors exist and ambiguous candidates are kept — their
    votes are harmless (the copies agree wherever such a read spans).
    Anchored candidates also win depth-cap slots first.

    b_mine: expand only these backbones (ascending indices into pr_b; a
    rank's share), with every seed frequency still counted over all of
    pr_b, so each kept backbone's candidates are those of the whole run.
    """
    idx = index or build_seed_index(pr_a, cfg, solid=solid, device=device)
    eb = extract_seed_entries(pr_b, cfg, device=device)
    key_b = (eb.hi.astype(np.uint64) << 32) | eb.lo.astype(np.uint64)
    S = idx.srt_key.shape[0]
    slot = np.searchsorted(idx.srt_key, key_b)
    hit = (slot < S) & (idx.srt_key[np.clip(slot, 0, S - 1)] == key_b)
    run = idx.run_of_slot[np.clip(slot, 0, S - 1)]
    freq = np.where(hit, idx.run_len[run], 0)
    # repeat mask on the COMBINED occurrence count (index side + query
    # side), matching ops/pairs.candidate_pairs exactly — it computes run
    # frequency over the concatenated entry set, so a k-mer repetitive in
    # the backbones alone must gate the run here too (round-3 verdict
    # item 7: the index-side-only mask diverged ~1% from the device join)
    ob = np.argsort(key_b, kind="stable")
    sb = key_b[ob]
    bnew = np.ones(sb.size, bool)
    if sb.size:
        bnew[1:] = sb[1:] != sb[:-1]
    brun = np.cumsum(bnew) - 1
    freq_b = np.empty(sb.size, np.int64)
    freq_b[ob] = np.bincount(brun, minlength=max(1, int(brun[-1]) + 1
                                                 if sb.size else 1))[brun]
    comb = freq + freq_b
    take_all = np.where(comb > cfg.max_seed_freq, 0, freq)
    k = cfg.k
    mean_la = float(pr_a.length.mean()) if pr_a.n_reads else 1.0

    outs_a, outs_b, outs_rel, outs_diag = [], [], [], []
    n_amb_dropped = 0
    order_b = (np.arange(pr_b.n_reads) if b_mine is None
               else np.asarray(b_mine, np.int64))
    for c_lo in range(0, order_b.size, chunk_reads):
        m = np.isin(eb.read, order_b[c_lo:c_lo + chunk_reads])
        take = take_all[m]
        total = int(take.sum())
        if total == 0:
            continue
        eidx = np.repeat(np.arange(take.shape[0]), take)
        within = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
        sl = idx.run_start[run[m]][eidx] + within
        a = idx.srt_read[sl].astype(np.int64)
        b = eb.read[m][eidx].astype(np.int64)
        rel = (idx.srt_strand[sl] != eb.strand[m][eidx]).astype(np.int32)
        pa = idx.srt_pos[sl].astype(np.int64)
        pb = eb.pos[m][eidx].astype(np.int64)
        lb = pr_b.length[b].astype(np.int64)
        pb_adj = np.where(rel == 1, lb - k - pb, pb)
        diag = pa - pb_adj
        rare = (comb[m][eidx] <= rare_cap) if rare_cap > 0 else None
        # aggregate per (a, b, rel): shared count + median diagonal
        order = _argsort_keys(diag, rel, b, a)
        a, b, rel, diag = a[order], b[order], rel[order], diag[order]
        gnew = np.ones(total, bool)
        gnew[1:] = ((a[1:] != a[:-1]) | (b[1:] != b[:-1])
                    | (rel[1:] != rel[:-1]))
        g_first = np.nonzero(gnew)[0]
        g_len = np.diff(np.append(g_first, total))
        keep = g_len >= cfg.min_shared_minimizers
        med = g_first + g_len // 2
        ga, gb = a[g_first][keep], b[g_first][keep]
        grel = rel[g_first][keep]
        gdiag = diag[med][keep]
        gcnt = g_len[keep]
        ganch = None
        rare_cnt = None
        if rare is not None:
            rare_cnt = np.add.reduceat(
                rare[order].astype(np.int64), g_first)[keep]
            ganch = rare_cnt > 0
        if (depth_cap > 0 or ganch is not None) and ga.size:
            # backbone position the read lands on (the same frame algebra
            # consensus_backbones uses for its window offset)
            glb = pr_b.length[gb].astype(np.int64)
            gla = pr_a.length[ga].astype(np.int64)
            pos = np.where(grel == 1, gdiag + glb - gla, -gdiag)
            bucket = np.clip(pos, 0, None) // max(int(mean_la), 1)
            if ganch is None:
                o2 = _argsort_keys(-gcnt, bucket, gb)
            else:  # anchored candidates win depth-cap slots first
                o2 = _argsort_keys(-gcnt, (~ganch).astype(np.int64),
                                   bucket, gb)
            bnew = np.ones(o2.shape[0], bool)
            bnew[1:] = ((gb[o2][1:] != gb[o2][:-1])
                        | (bucket[o2][1:] != bucket[o2][:-1]))
            first = np.nonzero(bnew)[0]
            seg_len = np.diff(np.append(first, o2.shape[0]))
            rank = np.arange(o2.shape[0]) - np.repeat(first, seg_len)
            keep_sel = (rank < depth_cap if depth_cap > 0
                        else np.ones(o2.shape[0], bool))
            if ganch is not None:
                # per-bucket anchored count; ambiguous candidates survive
                # only in buckets without anchored depth (see docstring)
                A = np.repeat(np.add.reduceat(
                    ganch[o2].astype(np.int64), first), seg_len)
                amb_drop = ~ganch[o2] & (A >= anchor_min)
                n_amb_dropped += int((keep_sel & amb_drop).sum())
                keep_sel &= ~amb_drop
            sel = o2[keep_sel]
            ga, gb, grel, gdiag = ga[sel], gb[sel], grel[sel], gdiag[sel]
        outs_a.append(ga)
        outs_b.append(gb)
        outs_rel.append(grel)
        outs_diag.append(gdiag)

    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs
                          else np.zeros(0, dt))
    a = cat(outs_a, np.int32)
    if rare_cap > 0:
        log.info("cross-indexed: %d candidate pairs (%d ambiguous dropped "
                 "by copy-aware filter, rare_cap=%d)", a.size,
                 n_amb_dropped, rare_cap)
    else:
        log.info("cross-indexed: %d candidate pairs", a.size)
    return (a, cat(outs_b, np.int32), cat(outs_rel, np.int32),
            cat(outs_diag, np.int32))


def find_candidates_all_indexed(
    pr: PackedReads,
    cfg: AssemblerConfig,
    solid=None,
    index: Optional[SeedIndex] = None,
    chunk_reads: int = 4096,
    device="cuda",
) -> SeedingResult:
    """Scalable all-vs-all candidates: the pair semantics of
    ops/pairs.candidate_pairs mode="all" (canonical a < b, rel = strand
    mismatch, diagonal = median over shared seeds of pos_a - pos_b', kept
    iff >= min_shared_minimizers shared seeds from runs of <= max_seed_freq)
    with memory bounded by the read chunk.  Each unordered anchor pair is
    enumerated once: read a's entries query the sorted index and keep hits
    with t > a.  Solid masking comes from the index side — a non-solid seed
    has no run in the solid-filtered index.  overflow is always 0.
    In a world of several ranks each rank takes a contiguous block of the
    query reads and the pair lists are gathered back in rank order.
    """
    idx = index or build_seed_index(pr, cfg, solid=solid, device=device)
    ent = extract_seed_entries(pr, cfg, device=device)
    key_e = (ent.hi.astype(np.uint64) << 32) | ent.lo.astype(np.uint64)
    S = idx.srt_key.shape[0]
    slot0 = np.searchsorted(idx.srt_key, key_e)
    hit = (slot0 < S) & (idx.srt_key[np.clip(slot0, 0, S - 1)] == key_e)
    run = idx.run_of_slot[np.clip(slot0, 0, S - 1)]
    freq = np.where(hit, idx.run_len[run], 0)
    # repeat mask: drop the whole run past max_freq
    take_all = np.where(freq > cfg.max_seed_freq, 0, freq)
    k = cfg.k
    read_len = pr.length.astype(np.int64)

    outs = {f: [] for f in ("a", "b", "rel", "diag", "shared")}
    n = pr.n_reads
    r_lo, r_hi = HP.block_range(n) if HP.nproc() > 1 else (0, n)
    HP.note("cand_query_reads", r_hi - r_lo)
    for a_lo in range(r_lo, r_hi, chunk_reads):
        a_hi = min(r_hi, a_lo + chunk_reads)
        m = (ent.read >= a_lo) & (ent.read < a_hi)
        take = take_all[m]
        total = int(take.sum())
        if total == 0:
            continue
        eidx = np.repeat(np.arange(take.shape[0]), take)
        within = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
        sl = idx.run_start[run[m]][eidx] + within
        a = ent.read[m][eidx].astype(np.int64)
        t = idx.srt_read[sl].astype(np.int64)
        keep = t > a                       # each unordered pair counted once
        a, t, sl, eidx2 = a[keep], t[keep], sl[keep], eidx[keep]
        if a.size == 0:
            continue
        rel = (ent.strand[m][eidx2] != idx.srt_strand[sl]).astype(np.int32)
        pa = ent.pos[m][eidx2].astype(np.int64)
        pt = idx.srt_pos[sl].astype(np.int64)
        lt = read_len[t]
        pt_adj = np.where(rel == 1, lt - k - pt, pt)
        diag = pa - pt_adj
        # aggregate per (a, t, rel): shared count + median diagonal
        order = _argsort_keys(diag, rel, t, a)
        a, t, rel, diag = a[order], t[order], rel[order], diag[order]
        gnew = np.ones(a.shape[0], bool)
        gnew[1:] = ((a[1:] != a[:-1]) | (t[1:] != t[:-1])
                    | (rel[1:] != rel[:-1]))
        g_first = np.nonzero(gnew)[0]
        g_len = np.diff(np.append(g_first, a.shape[0]))
        keep_g = g_len >= cfg.min_shared_minimizers
        med = g_first + g_len // 2
        outs["a"].append(a[g_first][keep_g])
        outs["b"].append(t[g_first][keep_g])
        outs["rel"].append(rel[g_first][keep_g])
        outs["diag"].append(diag[med][keep_g])
        outs["shared"].append(g_len[keep_g])

    cat = lambda xs: (np.concatenate(xs).astype(np.int32) if xs
                      else np.zeros(0, np.int32))
    fields = HP.allgather_concat({f: cat(v) for f, v in outs.items()})
    res = SeedingResult(overflow=0, **fields)
    log.info("all-indexed: %d candidate pairs", res.n_pairs)
    return res


def _anchors_for_chunk(q_lo: int, q_hi: int,
                       ent_read, ent_pos, ent_strand, srt_key, srt_read,
                       srt_pos, srt_strand, run_start, run_len, ent_run,
                       read_len, k: int, max_freq: int):
    """All anchors (q, t, rel, pos_q, pos_t_oriented) with q in [q_lo, q_hi)
    and t > q, via vectorized run expansion over the sorted index."""
    qm = (ent_read >= q_lo) & (ent_read < q_hi)
    runs = ent_run[qm]
    freq = run_len[runs]
    take = np.minimum(freq, max_freq)
    take = np.where(freq > max_freq, 0, take)       # repeat mask: drop runs
    total = int(take.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.int32), z, z
    # expansion: anchor i of query-entry e pairs it with index slot
    # run_start[run] + i
    eidx = np.repeat(np.arange(runs.shape[0]), take)
    within = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
    slot = run_start[runs][eidx] + within
    q = ent_read[qm][eidx].astype(np.int64)
    t = srt_read[slot].astype(np.int64)
    pos_q = ent_pos[qm][eidx].astype(np.int64)
    pos_t = srt_pos[slot].astype(np.int64)
    rel = (ent_strand[qm][eidx] != srt_strand[slot]).astype(np.int32)
    keep = t > q
    q, t, rel, pos_q, pos_t = (q[keep], t[keep], rel[keep],
                               pos_q[keep], pos_t[keep])
    lt = read_len[t].astype(np.int64)
    pos_t = np.where(rel == 1, lt - k - pos_t, pos_t)   # orient t's frame
    return q, t, rel, pos_q, pos_t


REP_DIAG_TOL_FRAC = 0.1   # allowed rep drift from the group median diagonal
REP_DIAG_TOL_MIN = 256    # ... floored (bases)


def _chain_representatives(q, t, rel, pos_q, pos_t, min_shared: int):
    """Group anchors per (q, t, rel); pick the diagonal-median anchor per
    SEG-bucket of the query axis; DROP representative outliers whose
    diagonal strays from the group's anchor-median diagonal by more than
    max(256, 0.1 x anchor span).

    The outlier filter is load-bearing: a single spurious shared k-mer far
    from the true diagonal (a 15-mer collision) otherwise becomes the
    chain's end representative, the extended span inflates to the whole
    read, the good true-overlap region subsidizes the garbage region
    through the AGGREGATE edit-rate gate, and the inflated coordinates
    misclassify the partner as contained — measured at judged scale as
    the cause of every remaining contig break (a 34.7 kb bridging read
    declared 'contained' in a 19.9 kb read via a span-inflated record).
    True indel drift is ~3% of the span even for 10%-error raw reads,
    far inside the 10% tolerance.

    Returns per-representative arrays plus the group id and the group
    anchor count (groups sorted, reps sorted by pos_q)."""
    diag = pos_q - pos_t
    order = _argsort_keys(diag, pos_q // SEG, rel, t, q)
    q, t, rel, pos_q, pos_t, diag = (x[order] for x in
                                     (q, t, rel, pos_q, pos_t, diag))
    bucket = pos_q // SEG
    gnew = np.ones(q.shape[0], bool)
    gnew[1:] = (q[1:] != q[:-1]) | (t[1:] != t[:-1]) | (rel[1:] != rel[:-1])
    gid = np.cumsum(gnew) - 1
    # shared-anchor count per group
    cnt = np.bincount(gid)
    ok_group = cnt >= min_shared
    # per-group MEDIAN diagonal + anchor pos_q span (diag-sorted per group)
    od = _argsort_keys(diag, gid)
    g_first = np.nonzero(np.ones_like(gid, bool))[0][
        np.concatenate([[True], gid[od][1:] != gid[od][:-1]])]
    g_start = np.zeros(cnt.shape[0], np.int64)
    g_start[gid[od][g_first]] = g_first
    med_diag = diag[od][np.clip(g_start[gid] + cnt[gid] // 2, 0,
                                diag.size - 1 if diag.size else 0)]
    span_q = np.zeros(cnt.shape[0], np.int64)
    np.maximum.at(span_q, gid, pos_q)
    span_min = np.full(cnt.shape[0], np.iinfo(np.int64).max)
    np.minimum.at(span_min, gid, pos_q)
    g_span = span_q - span_min
    # bucket runs inside groups (anchors are diag-sorted within a bucket)
    bnew = gnew.copy()
    bnew[1:] |= bucket[1:] != bucket[:-1]
    bstart = np.nonzero(bnew)[0]
    blen = np.diff(np.append(bstart, q.shape[0]))
    rep = bstart + blen // 2                    # diagonal median per bucket
    tol = np.maximum(REP_DIAG_TOL_MIN,
                     (REP_DIAG_TOL_FRAC * g_span[gid[rep]]).astype(np.int64))
    keep = (ok_group[gid[rep]]
            & (np.abs(diag[rep] - med_diag[rep]) <= tol))
    rep = rep[keep]
    return (q[rep], t[rep], rel[rep], pos_q[rep], pos_t[rep], gid[rep],
            cnt[gid[rep]])



# one-slot device cache for the (large, call-invariant) packed long-read
# plane: segment batches gather their DP windows on the device from it, so
# a batch ships seven int32 id vectors instead of materialized code windows
_DEV_SEG_CACHE: dict = {"key": None, "device": None, "vals": None}


def _device_seg_reads(pr: PackedReads, device: torch.device):
    if _DEV_SEG_CACHE["key"] is pr.packed and _DEV_SEG_CACHE["device"] == device:
        return _DEV_SEG_CACHE["vals"]
    vals = (words_to_tensor(pr.packed, device).reshape(-1),
            torch.from_numpy(pr.length.astype(np.int32)).to(device),
            int(pr.packed.shape[1]))
    _DEV_SEG_CACHE.update(key=pr.packed, device=device, vals=vals)
    return vals


def _seg_prep(packed_flat, rlen, qid, tid, relv, q0, seglen, t0, kindv,
              wwords: int, k: int):
    """Device segment-window prep: segment ids in, DP operands out.

    The same window math as the reference's ``_seg_prep_fn`` — query gather
    in [q0, q0+seglen), oriented (revcomp when rel=1) target window from
    t0 - SLACK, the head-segment reversal folded into the gather indices —
    read as 2-bit codes straight from the device-resident packed plane.
    Ids are int64 tensors; returns int32 (P, Lq_seg), (P, Wt_seg).
    """
    Lq_seg = SEG + 2 * k
    Wt_seg = Lq_seg + 2 * SLACK
    dev = packed_flat.device
    la = rlen[qid].to(torch.int64)
    lb = rlen[tid].to(torch.int64)
    xs = torch.arange(Lq_seg, dtype=torch.int64, device=dev)[None, :]
    head = (kindv == 1)[:, None]
    # head segments align REVERSED (free target start -> free end):
    # emit position seglen-1-x instead of materialize-then-reverse
    qi = q0[:, None] + torch.where(head, seglen[:, None] - 1 - xs, xs)
    wq = packed_flat[qid[:, None] * wwords
                     + torch.clamp(qi >> 4, 0, wwords - 1)].to(torch.int64)
    qc = (wq >> (2 * (qi & 15))) & 3
    q_ok = (xs < seglen[:, None]) & (qi >= 0) & (qi < la[:, None])
    qwin = torch.where(q_ok, qc, SENT_BASE).to(torch.int32)

    twin_len = torch.clamp(seglen + 2 * SLACK, max=Wt_seg)
    t_or0 = t0 - SLACK
    ys = torch.arange(Wt_seg, dtype=torch.int64, device=dev)[None, :]
    wy = torch.where(head, twin_len[:, None] - 1 - ys, ys)
    tpos = t_or0[:, None] + wy
    flip = (relv == 1)[:, None]
    pos = torch.where(flip, lb[:, None] - 1 - tpos, tpos)
    valid = (pos >= 0) & (pos < lb[:, None]) & (wy >= 0)
    wt = packed_flat[tid[:, None] * wwords
                     + torch.clamp(pos >> 4, 0, wwords - 1)].to(torch.int64)
    tc = (wt >> (2 * (pos & 15))) & 3
    tc = torch.where(flip, 3 - tc, tc)
    t_or = torch.where(valid, tc, SENT_BASE).to(torch.int32)
    return qwin, t_or


def compute_overlaps_long(
    pr: PackedReads,
    cfg: AssemblerConfig,
    device="cuda",
    chunk_reads: int = 512,
    seg_batch: int = 4096,
    mesh=None,
) -> OverlapRecords:
    """All-vs-all overlaps of a LONG read set (multi-kb pads) on `device`.

    In a world of several ranks the sorted index is built on every rank,
    but the query-read loop (anchors, chaining, segment DPs) is split into
    contiguous rank blocks on each rank's own device, and the records are
    gathered back in rank order."""
    dev = resolve_device(device)
    partition = HP.nproc() > 1
    edit = default_edit(cfg, HP.local_mesh(mesh) if partition else mesh)
    k = cfg.k
    n = pr.n_reads
    read_len = pr.length.astype(np.int64)
    tm: Dict[str, float] = dict(index_s=0.0, anchor_s=0.0, chain_s=0.0,
                                segprep_s=0.0, dp_s=0.0, n_anchors=0,
                                n_pairs=0, n_segments=0, bytes_up=0)
    t0 = time.perf_counter()

    # ---- sorted minimizer index (host arrays; one global sort) ----
    ent = extract_seed_entries(pr, cfg, device=dev)
    key = (ent.hi.astype(np.uint64) << 32) | ent.lo.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    srt_key = key[order]
    srt_read = ent.read[order]
    srt_pos = ent.pos[order]
    srt_strand = ent.strand[order]
    rnew = np.ones(srt_key.shape[0], bool)
    rnew[1:] = srt_key[1:] != srt_key[:-1]
    run_id_sorted = np.cumsum(rnew) - 1
    run_start = np.nonzero(rnew)[0]
    run_len = np.diff(np.append(run_start, srt_key.shape[0]))
    ent_run = np.empty(srt_key.shape[0], np.int64)
    ent_run[order] = run_id_sorted                # run id per ORIGINAL entry
    dev_reads = _device_seg_reads(pr, dev)
    tm["index_s"] = time.perf_counter() - t0
    tm["dev_prep"] = True

    out = {f: [] for f in ("a", "b", "rel", "score", "a_start", "a_end",
                           "b_start", "b_end", "dist")}
    # split at read granularity: per-chunk records come out sorted by
    # ascending query read, so any chunking of a contiguous read block
    # concatenates to the same order
    r_lo, r_hi = HP.block_range(n) if partition else (0, n)
    spans = [(s, min(r_hi, s + chunk_reads))
             for s in range(r_lo, r_hi, chunk_reads)]
    HP.note("long_query_reads", r_hi - r_lo)
    for ci, (q_lo, q_hi) in enumerate(spans):
        if ci % 4 == 0:
            log.info("overlap-long: chunk %d/%d (reads %d-%d)",
                     ci, len(spans), q_lo, q_hi)
        t1 = time.perf_counter()
        a_q, a_t, a_rel, a_pq, a_pt = _anchors_for_chunk(
            q_lo, q_hi, ent.read, ent.pos, ent.strand, srt_key, srt_read,
            srt_pos, srt_strand, run_start, run_len, ent_run, read_len,
            k, cfg.max_seed_freq)
        t2 = time.perf_counter()
        tm["anchor_s"] += t2 - t1
        tm["n_anchors"] += int(a_q.size)
        if a_q.size == 0:
            continue
        rq, rt, rrel, rpq, rpt, rgid, rcnt = _chain_representatives(
            a_q, a_t, a_rel, a_pq, a_pt, cfg.min_shared_minimizers)
        tm["chain_s"] += time.perf_counter() - t2
        if rq.size == 0:
            continue
        res = _align_chains(rq, rt, rrel, rpq, rpt, rgid, rcnt, read_len,
                            cfg, edit, k, seg_batch, tm=tm, dev=dev_reads)
        for f in out:
            out[f].append(res[f])

    cat = {f: (np.concatenate(v).astype(np.int32) if v
               else np.zeros(0, np.int32)) for f, v in out.items()}
    if partition:
        cat = HP.allgather_concat(cat)
    rec = OverlapRecords(
        a_len=pr.length[cat["a"]].astype(np.int32),
        b_len=pr.length[cat["b"]].astype(np.int32), **cat)
    for key in ("index_s", "anchor_s", "chain_s", "segprep_s", "dp_s"):
        tm[key] = round(tm[key], 3)
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(tm)
    log.info("overlap-long: %d overlaps; split %s", rec.n, tm)
    return rec


ANCHOR_DENSITY_FLOOR = 500   # min 1 shared anchor per this many span bases


def _align_chains(rq, rt, rrel, rpq, rpt, rgid, rcnt, read_len, cfg, edit,
                  k: int, seg_batch: int, tm: Optional[dict] = None,
                  dev=None):
    """Cut each chain into segments, run batched Myers, aggregate per pair."""
    if tm is None:
        tm = {}
    t_sp0 = time.perf_counter()
    # group boundaries over representatives (gid sorted)
    gnew = np.ones(rq.shape[0], bool)
    gnew[1:] = rgid[1:] != rgid[:-1]
    g_first = np.nonzero(gnew)[0]
    g_len = np.diff(np.append(g_first, rq.shape[0]))
    n_pairs = g_first.shape[0]
    pair_of_rep = np.cumsum(gnew) - 1

    la = read_len[rq[g_first]]
    lb = read_len[rt[g_first]]
    d_first = rpq[g_first] - rpt[g_first]
    last = g_first + g_len - 1
    d_last = rpq[last] - rpt[last]
    # chain span extended to the read ends along the local end diagonals,
    # clipped by target availability (same segment algebra as the gate)
    qs = np.maximum(0, d_first)
    qe = np.minimum(la, lb + d_last)
    valid_pair = qe - qs >= cfg.min_overlap_len
    # anchor-density prefilter (wall-clock only; the full-span DP gate is
    # the correctness backstop): a true overlap at w<=16 keeps >= ~1 shared
    # minimizer per ~70 bases even for 10%-error raw reads, so a chain
    # whose span exceeds 500 bases/anchor is a seed collision between
    # unrelated reads — rejecting it here skips its (now fully split and
    # aligned, hence expensive) segment DPs
    valid_pair &= rcnt[g_first].astype(np.int64) * ANCHOR_DENSITY_FLOOR >= (
        qe - qs)

    # ---- segment table ----
    # one segment per (rep boundary): [prev_cut, cut) on the query axis;
    # cut points = rep positions, plus the extended ends
    seg_pair, seg_q0, seg_q1, seg_t0, seg_t1, seg_kind = [], [], [], [], [], []
    # vectorized: segment i spans reps (i-1, i) inside a group; ends are
    # handled by substituting the extended bounds
    rep_q = rpq
    rep_t = rpt
    prev = np.arange(rq.shape[0]) - 1
    is_first = gnew
    pid = pair_of_rep
    # inner segments: from rep[prev] to rep[i] (same group, not first)
    inner = ~is_first
    if inner.any():
        seg_pair.append(pid[inner])
        seg_q0.append(rep_q[prev[inner]])
        seg_q1.append(rep_q[inner] + k)
        seg_t0.append(rep_t[prev[inner]])
        seg_t1.append(rep_t[inner] + k)
        seg_kind.append(np.zeros(int(inner.sum()), np.int8))
    # head segment: extended start -> first rep (aligned REVERSED: free
    # target start becomes a free end, giving the exact b_start)
    seg_pair.append(pid[g_first])
    seg_q0.append(qs)
    seg_q1.append(rep_q[g_first] + k)
    seg_t0.append(qs - d_first)
    seg_t1.append(rep_t[g_first] + k)
    seg_kind.append(np.full(n_pairs, 1, np.int8))
    # tail segment: last rep -> extended end (free target end -> exact b_end)
    seg_pair.append(pid[last])
    seg_q0.append(rep_q[last])
    seg_q1.append(qe)
    seg_t0.append(rep_t[last])
    seg_t1.append(qe - d_last)
    seg_kind.append(np.full(n_pairs, 2, np.int8))

    seg_pair = np.concatenate(seg_pair)
    seg_q0 = np.concatenate(seg_q0)
    seg_q1 = np.concatenate(seg_q1)
    seg_t0 = np.concatenate(seg_t0)
    seg_t1 = np.concatenate(seg_t1)
    seg_kind = np.concatenate(seg_kind)

    # drop degenerate/invalid segments and segments of invalid pairs
    ok = (seg_q1 > seg_q0) & valid_pair[seg_pair]
    seg_pair, seg_q0, seg_q1, seg_t0, seg_t1, seg_kind = (
        x[ok] for x in (seg_pair, seg_q0, seg_q1, seg_t0, seg_t1, seg_kind))

    Lq_seg = SEG + 2 * k                      # static query capacity
    Wt_seg = Lq_seg + 2 * SLACK
    # Segments longer than the capacity are SPLIT into <= Lq_seg sub-
    # segments with target cuts linearly interpolated between the segment's
    # anchored ends, so the ENTIRE claimed span is aligned and charged
    # distance.  (A previous revision clamped oversized segments to the
    # capacity instead: only 414 of a multi-kb anchor gap was aligned while
    # the full gap stayed in the identity denominator, so a spurious
    # 2-anchor chain between UNRELATED reads collected ~0.5 edits/base on
    # its few clamped windows yet passed the edit-rate gate — measured at
    # judged scale as 15,236 fabricated overlaps joining loci megabases
    # apart, the direct cause of the 32-contig fragmentation.)  For true
    # overlaps reps sit every <= SEG bases, so splitting only triggers on
    # anchor deserts and leaves dense chains byte-identical.
    span_q = seg_q1 - seg_q0
    n_sub = np.maximum(1, -(-span_q // Lq_seg))
    if (n_sub > 1).any():
        tot = int(n_sub.sum())
        ridx = np.repeat(np.arange(seg_pair.shape[0]), n_sub)
        j = np.arange(tot) - np.repeat(np.cumsum(n_sub) - n_sub, n_sub)
        nsr = n_sub[ridx]
        span_t = seg_t1 - seg_t0
        qa = seg_q0[ridx] + (span_q[ridx] * j) // nsr
        qb = seg_q0[ridx] + (span_q[ridx] * (j + 1)) // nsr
        ta = seg_t0[ridx] + (span_t[ridx] * j) // nsr
        tb = seg_t0[ridx] + (span_t[ridx] * (j + 1)) // nsr
        kind = seg_kind[ridx].copy()
        # the head's free-target-end sub is the OUTERMOST one (j == 0,
        # contains qs -> b_start); the tail's is the last (contains qe)
        kind[(seg_kind[ridx] == 1) & (j > 0)] = 0
        kind[(seg_kind[ridx] == 2) & (j < nsr - 1)] = 0
        seg_pair, seg_q0, seg_q1, seg_t0, seg_t1, seg_kind = (
            seg_pair[ridx], qa, qb, ta, tb, kind)

    n_seg = seg_pair.shape[0]
    tm["n_pairs"] = tm.get("n_pairs", 0) + n_pairs
    tm["n_segments"] = tm.get("n_segments", 0) + n_seg
    tm["segprep_s"] = (tm.get("segprep_s", 0.0)
                       + time.perf_counter() - t_sp0)
    dist_sum = np.zeros(n_pairs, np.int64)
    t_begin = np.zeros(n_pairs, np.int64)     # exact b_start (oriented)
    t_end = np.zeros(n_pairs, np.int64)       # exact b_end (oriented)

    # per-pair oriented target codes are gathered lazily per batch
    rel_of_pair = rrel[g_first]
    q_of_pair = rq[g_first]
    t_of_pair = rt[g_first]

    packed_flat, rlen_dev, wwords = dev
    ddev = packed_flat.device
    i64 = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.int64)).to(ddev)
    for s in range(0, n_seg, seg_batch):
        t_w0 = time.perf_counter()
        sl = slice(s, min(n_seg, s + seg_batch))
        p = seg_pair[sl]
        nbv = p.shape[0]
        P = seg_batch
        q0v = np.pad(seg_q0[sl], (0, P - nbv))
        q1v = np.pad(seg_q1[sl], (0, P - nbv))
        t0v = np.pad(seg_t0[sl], (0, P - nbv))
        kindv = np.pad(seg_kind[sl], (0, P - nbv))
        pv = np.pad(p, (0, P - nbv))

        qid = q_of_pair[pv]
        tid = t_of_pair[pv]
        relv = rel_of_pair[pv]
        seglen = np.where(np.arange(P) < nbv, q1v - q0v, 0).astype(np.int64)
        head = kindv == 1
        t_or0 = t0v - SLACK
        twin_len = np.minimum(seglen + 2 * SLACK, Wt_seg)
        t_dp0 = time.perf_counter()
        tm["segprep_s"] = tm.get("segprep_s", 0.0) + t_dp0 - t_w0
        tm["bytes_up"] = tm.get("bytes_up", 0) + 7 * 4 * P
        seglen_d = i64(seglen)
        qwin, t_or = _seg_prep(packed_flat, rlen_dev, i64(qid), i64(tid),
                               i64(relv), i64(q0v), seglen_d, i64(t0v),
                               i64(kindv), wwords, k)
        r = edit(qwin, t_or, seglen_d.to(torch.int32),
                 i64(twin_len).to(torch.int32))
        dist = r.dist.cpu().numpy().astype(np.int64)[:nbv]
        tend = r.tend.cpu().numpy().astype(np.int64)[:nbv]
        tm["dp_s"] = tm.get("dp_s", 0.0) + time.perf_counter() - t_dp0
        # tend-1 is the last aligned window column for forward tails; a
        # reversed head's window col x maps to t_or0 + twin_len - 1 - x
        hb = head[:nbv]
        tb = kindv[:nbv] == 2
        np.add.at(dist_sum, p, dist)
        t_end[p[tb]] = t_or0[:nbv][tb] + tend[tb]
        t_begin[p[hb]] = (t_or0[:nbv][hb] + twin_len[:nbv][hb]) - tend[hb]

    identity_den = np.maximum(qe - qs, 1)
    max_ed = np.floor((1.0 - cfg.min_identity) * identity_den).astype(np.int64)
    keep = valid_pair & (dist_sum <= max_ed)

    a = q_of_pair[keep]
    b = t_of_pair[keep]
    rel = rel_of_pair[keep]
    lbk = read_len[b]
    b_or_s = np.clip(t_begin[keep], 0, lbk)
    b_or_e = np.clip(t_end[keep], b_or_s, lbk)
    b_fwd_s = np.where(rel == 1, lbk - b_or_e, b_or_s)
    b_fwd_e = np.where(rel == 1, lbk - b_or_s, b_or_e)
    span = (qe - qs)[keep]
    matches = np.maximum(span - dist_sum[keep], 0)
    return dict(a=a, b=b, rel=rel,
                score=(cfg.match * matches).astype(np.int64),
                a_start=qs[keep], a_end=qe[keep],
                b_start=b_fwd_s, b_end=b_fwd_e, dist=dist_sum[keep])
