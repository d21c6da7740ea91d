"""Stage 5 (judged config 5) — hybrid correction + consensus polishing.

PyTorch port of ``hga_tpu.models.correction``: short reads are anchored to
each backbone (long read, or contig during polishing) through the sorted
seed index (models/overlap_long), each batch of (short read x backbone
window) alignments runs through the engine's DP and traceback, whose
column/insertion votes land in one flat buffer, and one consensus call
rewrites every backbone column.  Batch prep (read gather, orientation,
in-backbone segment clip, target window gather) runs on the device from the
resident packed reads, so a batch ships four id vectors.

Engines (cfg.corr_engine): "myers", the production engine: on the card one
launch of K2' (ops/myers_cuda.myers_votes_cuda) runs a batch's Myers DP
with its planes in shared memory, the identity gate, the plane traceback
and the vote atomics; on the CPU its plain version does (ops/pileup).
"sw": the scored dirs wavefront DP (ops/align.banded_sw_batch_dirs), the
gate score >= min_score and the dirs traceback (ops/pileup), plain torch
on either device, as the reference's engine is plain XLA.

Consensus covers substitutions, deletions (symbol 4) and up-to-3-base
insertions per column, restored when a majority of covering reads agrees.

In a world of several ranks (parallel/): correction splits every length
group's backbones and polish its contigs into contiguous rank blocks, each
corrected on the rank's own device and gathered back in rank order; and
``consensus_backbones(mesh=...)`` on a mesh of several ranks (copy
arbitration's votes) splits each batch over the ranks, each rank voting
into a zeroed buffer, and sums the buffers with an all_reduce — the votes
are order-free int32 adds, so the buffer is the one-device buffer.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import (PackedReads, decode_bases, pack_reads,
                                     unpack_codes)
from hga_tpu_torch.models.overlap import SENT_BASE
from hga_tpu_torch.models.seeding import drop_unsolid, extract_seed_entries
from hga_tpu_torch.ops import pileup as PU
from hga_tpu_torch.ops.align import banded_sw_batch_dirs
from hga_tpu_torch.ops.kmer import unpack_bases, words_to_tensor
from hga_tpu_torch.ops.myers_cuda import myers_votes_cuda
from hga_tpu_torch.ops.pairs import candidate_pairs
from hga_tpu_torch.parallel import hostpart as HP
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# wall-clock split of the last consensus_backbones call (same keys as the
# reference): candidate seconds, per-batch host prep, loop and drain
# seconds, bytes shipped host->device
LAST_TIMINGS: dict = {}

INS_SLOTS = 3
MAX_VOTE_COLS = 24_000_000  # nb * Lpad budget per correction group


def find_candidates_cross(pr_a: PackedReads, pr_b: PackedReads,
                          cfg: AssemblerConfig,
                          pair_cap: Optional[int] = None,
                          solid=None, seed_index=None, device="cuda",
                          b_mine: Optional[np.ndarray] = None):
    """Candidates between two read sets as host arrays (a, b, rel, diag):
    `a` indexes pr_a, `b` indexes pr_b.

    solid: optional (hi, lo) solid k-mers; only solid seeds generate
    candidates.  With a seed_index, or above INDEXED_ROUTE_ENTRIES estimated
    entries, the memory-bounded sorted-index route of models/overlap_long.py
    runs; otherwise both read sets' seed entries go through the bounded
    self-join of ops/pairs.py in "cross" mode.  pair_cap is the reference's
    signature only: the self-join returns every kept pair.  b_mine (the
    sorted-index route only): the candidates of these backbones alone, seed
    frequencies counted over all of pr_b (a rank's share of the whole).
    """
    from hga_tpu_torch.models import overlap_long as OL

    dev = resolve_device(device)
    est = (int(pr_a.length.sum()) + int(pr_b.length.sum())) \
        // max(cfg.w, 1) * 2
    if (seed_index is not None or b_mine is not None
            or est > OL.INDEXED_ROUTE_ENTRIES):
        return OL.find_candidates_cross_indexed(
            pr_a, pr_b, cfg, solid=solid, index=seed_index,
            depth_cap=cfg.corr_depth_cap,
            rare_cap=max(0, cfg.corr_rare_seed_freq),
            anchor_min=cfg.corr_anchor_min, device=dev, b_mine=b_mine)
    ea = extract_seed_entries(pr_a, cfg, device=dev)
    eb = extract_seed_entries(pr_b, cfg, device=dev)
    na = pr_a.n_reads
    hi, lo = drop_unsolid(np.concatenate([ea.hi, eb.hi]),
                          np.concatenate([ea.lo, eb.lo]), solid, cfg, dev,
                          "correction")
    t = lambda *xs: torch.from_numpy(
        np.concatenate(xs).astype(np.int64)).to(dev)
    cp = candidate_pairs(
        t(hi), t(lo), t(ea.read, eb.read + na), t(ea.pos, eb.pos),
        t(ea.strand, eb.strand), t(pr_a.length, pr_b.length),
        t(np.zeros(na), np.ones(pr_b.n_reads)), k=cfg.k,
        max_freq=cfg.max_seed_freq, min_shared=cfg.min_shared_minimizers,
        mode="cross")
    host = lambda x: x.cpu().numpy()
    return host(cp.a), host(cp.b) - na, host(cp.rel), host(cp.diag)


def _pack2(vals: np.ndarray) -> np.ndarray:
    """Pack (R, L) values 0..3 into uint32 words, 16 per word (the read code
    layout of io/encode.pack_reads) — quality-weight planes ride this way."""
    R, L = vals.shape
    Lp = ((L + 15) // 16) * 16
    v = np.zeros((R, Lp), np.uint32)
    v[:, :L] = vals.astype(np.uint32) & 3
    v = v.reshape(R, Lp // 16, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    return (v << shifts).sum(axis=2, dtype=np.uint32)


# one-slot device cache for the (large, call-invariant) packed short reads:
# correct_long_reads calls consensus_backbones once per length group, and
# both polish passes reuse the same reads — one device copy serves them all
_DEV_READS_CACHE: dict = {"key": None, "device": None, "weighted": None,
                          "vals": None}


def _device_reads(reads: PackedReads, r_qw: Optional[np.ndarray],
                  device: torch.device):
    # the cache HOLDS the host array, so `is` identity cannot be recycled
    # the way id() of a garbage-collected array can
    if (_DEV_READS_CACHE["key"] is reads.packed
            and _DEV_READS_CACHE["device"] == device
            and _DEV_READS_CACHE["weighted"] == (r_qw is not None)):
        return _DEV_READS_CACHE["vals"]
    vals = (words_to_tensor(reads.packed, device),
            torch.from_numpy(reads.length.astype(np.int32)).to(device),
            words_to_tensor(_pack2(r_qw), device) if r_qw is not None
            else None)
    _DEV_READS_CACHE.update(key=reads.packed, device=device,
                            weighted=r_qw is not None, vals=vals)
    return vals


def _prep(band: int, Lq: int, Wt: int, r_packed, r_len, r_qwp, b_packed,
          b_len, aa, bb, rr, dd, nbatch: int):
    """On-device batch prep: candidate ids in, DP operands out.

    The math of the reference's ``_prep_fn`` — read gather + unpack,
    orientation (read-side revcomp), in-backbone segment clip, target window
    gather — from the device-resident packed planes.  Ids are int64
    tensors; returns int32 (q, t_win, qlen, tlen, bb, off, lb, qw).
    """
    band2 = band // 2
    dev = r_packed.device
    P = aa.shape[0]
    la = r_len[aa].to(torch.int64)
    lb = b_len[bb].to(torch.int64)
    pos = torch.arange(Lq, dtype=torch.int64, device=dev)[None, :]
    q = unpack_bases(r_packed[aa])[:, :Lq]
    q = torch.where(pos < la[:, None], q, SENT_BASE)
    flip = (rr == 1)[:, None]
    qidx = (la[:, None] - 1) - pos
    take = lambda x, i: torch.gather(x, 1, torch.clamp(i, 0, Lq - 1))
    q_rc = torch.where(qidx >= 0, take(q, qidx), SENT_BASE)
    q_rc = torch.where(q_rc < 4, 3 - q_rc, q_rc)
    q = torch.where(flip, q_rc, q)
    off = torch.where(flip[:, 0], dd + lb - la, -dd) - band2
    base_off = off + band2
    qs = torch.minimum(torch.clamp(-base_off, min=0), la)
    seg = torch.minimum(torch.maximum(lb - base_off, qs), la) - qs
    gidx = pos + qs[:, None]
    q = torch.where(pos < seg[:, None], take(q, gidx), SENT_BASE)
    off = off + qs
    qw = None
    if r_qwp is not None:
        qw = unpack_bases(r_qwp[aa])[:, :Lq]
        qw = torch.where(pos < la[:, None], qw, 0)
        qw = torch.where(flip, torch.where(qidx >= 0, take(qw, qidx), 0), qw)
        qw = torch.where(pos < seg[:, None], take(qw, gidx), 0)
        qw = qw.to(torch.int32)
    # target window straight out of the packed backbone plane
    wpos = torch.arange(Wt, dtype=torch.int64, device=dev)[None, :] \
        + off[:, None]
    in_range = (wpos >= 0) & (wpos < lb[:, None])
    wp = torch.clamp(wpos, 0, 16 * b_packed.shape[1] - 1)
    words = torch.gather(b_packed[bb], 1, wp >> 4).to(torch.int64)
    tc = (words >> (2 * (wp & 15))) & 3
    t_win = torch.where(in_range, tc, SENT_BASE)
    live = torch.arange(P, dtype=torch.int64, device=dev) < nbatch
    qlen = torch.where(live, seg, 0)
    tlen = torch.where(live, Wt, 0)
    i32 = lambda x: x.to(torch.int32).contiguous()
    return (i32(q), i32(t_win), i32(qlen), i32(tlen), i32(bb), i32(off),
            i32(lb), qw)


def _votes_into(merged, cfg: AssemblerConfig, size_v: int, lpad: int,
                q, t, ql, tl, bb, off, lb, qw=None, *,
                min_score: Optional[int] = None):
    """One batch's votes into `merged`, by cfg.corr_engine.  "myers": the
    Myers planes DP -> identity gate -> plane traceback -> votes, through
    K2''s wrapper (the kernel for CUDA tensors, its plain version for CPU
    tensors).  "sw": the scored dirs DP (ops/align.banded_sw_batch_dirs)
    -> gate score >= min_score (default cfg.min_overlap_score) -> dirs
    traceback -> votes (ops/pileup), plain torch on either device."""
    if cfg.corr_engine == "sw":
        if qw is not None:
            raise ValueError(
                "use_quality requires corr_engine='myers' (the production "
                "engine); the scored-dirs engine is unweighted")
        if min_score is None:
            min_score = cfg.min_overlap_score
        res, dirs = banded_sw_batch_dirs(q, t, ql, tl, band=cfg.band,
                                         match=cfg.match,
                                         mismatch=cfg.mismatch, gap=cfg.gap)
        qend = torch.where(res.score >= min_score, res.qend, 0)
        return PU.accumulate_backbone_votes_merged(
            merged, dirs, qend, res.tend, q, bb, off, lb, size_v=size_v,
            lpad=lpad, band=cfg.band, Lt=t.shape[1], ins_slots=INS_SLOTS)
    # path bound: gated rows walk <= qlen + dist <= Lq * (2 - id) steps
    Lq_ = q.shape[1]
    steps = Lq_ + int((1.0 - cfg.min_identity) * Lq_) + 2
    _, merged = myers_votes_cuda(
        merged, q, t, ql, tl, bb, off, lb, qw, min_identity=cfg.min_identity,
        size_v=size_v, lpad=lpad, ins_slots=INS_SLOTS, max_steps=steps)
    return merged


def _votes_step(cfg: AssemblerConfig, size_v: int, lpad: int, mesh,
                min_score: Optional[int]):
    """One batch's votes into `merged`: _votes_into on one device; on a
    mesh of several ranks each rank votes its contiguous share of the batch
    into a zeroed buffer and the ranks' buffers are summed into `merged`
    (a batch not divisible by the mesh size votes whole on every rank)."""

    def single(merged, *args):
        return _votes_into(merged, cfg, size_v, lpad, *args,
                           min_score=min_score)

    if mesh is None or mesh.size <= 1:
        return single
    from hga_tpu_torch.parallel.collectives import all_reduce_sum

    P = mesh.size

    def step(merged, *args):
        N = args[0].shape[0]
        if N % P:
            return single(merged, *args)
        nb = N // P
        mine = slice(mesh.rank * nb, (mesh.rank + 1) * nb)
        part = single(torch.zeros_like(merged),
                      *(None if x is None else x[mine].contiguous()
                        for x in args))
        merged += all_reduce_sum(part)
        return merged

    return step


def consensus_backbones(
    backbones: PackedReads,
    reads: PackedReads,
    cfg: AssemblerConfig,
    batch_pairs: Optional[int] = None,
    min_score: Optional[int] = None,
    device="cuda",
    solid=None,
    seed_index=None,
    cands=None,
    mesh=None,
) -> List[str]:
    """Correct every backbone by short-read pileup consensus (device DP,
    traceback and votes: one K2' launch a batch on the Myers engine);
    returns corrected sequences.

    min_score: the sw engine's alignment score gate (default
    cfg.min_overlap_score).  cands: optional pre-computed (a, b, rel, diag)
    candidate arrays with b indexing `backbones`.  mesh: a mesh of several
    ranks splits each batch's votes over them (module docstring).
    """
    dev = resolve_device(device)
    if batch_pairs is None:
        batch_pairs = cfg.corr_batch_pairs
    nb = backbones.n_reads
    Lpad = backbones.pad_len
    if min_score is None:
        min_score = cfg.min_overlap_score

    t_cand0 = time.perf_counter()
    if cands is not None:
        a, b, rel, diag = cands
    else:
        a, b, rel, diag = find_candidates_cross(
            reads, backbones, cfg, solid=solid, seed_index=seed_index,
            device=dev)
    t_cand = time.perf_counter() - t_cand0
    log.info("correction: %d read->backbone candidates for %d backbones",
             len(a), nb)
    batch_pairs = min(batch_pairs,
                      max(8, 1 << (max(1, len(a)) - 1).bit_length()))

    Lq = reads.packed.shape[1] * 16
    past = np.arange(Lq)[None, :] >= reads.length[:, None]
    # quality-weighted votes (cfg.use_quality): phred -> tier weights 1..3
    r_qw = None
    if cfg.use_quality:
        if reads.qual is None:
            log.warning("use_quality=True but reads carry no quality plane "
                        "(load with keep_quality) — votes stay unweighted")
        else:
            qph = reads.qual[:, :Lq].astype(np.int32)
            r_qw = (1 + (qph >= 13) + (qph >= 28)).astype(np.int32)
            r_qw[past] = 0
    b_codes_fwd = unpack_codes(backbones.packed).astype(np.int32)
    pastb = np.arange(Lpad)[None, :] >= backbones.length[:, None]
    b_codes_fwd[pastb] = SENT_BASE

    Wt = Lq + cfg.band + 8
    # ONE flat vote buffer (column votes, then insertion votes, then one
    # sink slot for dropped moves), updated in place per batch
    size_v = nb * Lpad * PU.N_SYM
    size_all = size_v + nb * Lpad * INS_SLOTS * 4
    merged = torch.zeros(size_all + 1, dtype=torch.int32, device=dev)
    step = _votes_step(cfg, size_v, Lpad, mesh, min_score)

    r_dev, rlen_dev, rqw_dev = _device_reads(reads, r_qw, dev)
    b_dev = words_to_tensor(backbones.packed, dev)
    blen_dev = torch.from_numpy(backbones.length.astype(np.int32)).to(dev)
    i64 = lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.int64)).to(dev)

    bytes_up = 0
    t_prep = 0.0
    t_loop0 = time.perf_counter()
    for s in range(0, len(a), batch_pairs):
        t_b0 = time.perf_counter()
        aa = a[s : s + batch_pairs].astype(np.int64)
        bb = b[s : s + batch_pairs].astype(np.int64)
        rr = rel[s : s + batch_pairs].astype(np.int64)
        dd = diag[s : s + batch_pairs].astype(np.int64)
        nbatch = aa.shape[0]
        P = batch_pairs
        if nbatch < P:
            padn = P - nbatch
            aa = np.pad(aa, (0, padn))
            bb = np.pad(bb, (0, padn))
            rr = np.pad(rr, (0, padn))
            dd = np.pad(dd, (0, padn))
        args = _prep(cfg.band, Lq, Wt, r_dev, rlen_dev, rqw_dev, b_dev,
                     blen_dev, i64(aa), i64(bb), i64(rr), i64(dd), nbatch)
        merged = step(merged, *args)
        bytes_up += 4 * 4 * P
        t_prep += time.perf_counter() - t_b0

    t_drain0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_drain = time.perf_counter() - t_drain0
    LAST_TIMINGS.clear()
    LAST_TIMINGS.update(
        cand_s=round(t_cand, 3), n_pairs=len(a),
        n_batches=-(-len(a) // batch_pairs) if len(a) else 0,
        host_prep_s=round(t_prep, 3),
        loop_s=round(time.perf_counter() - t_loop0, 3),
        drain_s=round(t_drain, 3), dev_prep=True,
        bytes_up=bytes_up)
    log.info("correction consensus: %s", LAST_TIMINGS)

    # consensus call over all backbones at once, on the device; with
    # quality weighting the depth floor scales x3 (votes are in weighted
    # units).  Insertions are called on the device and only the called
    # entries come back.
    min_depth = cfg.min_pileup_depth * (3 if r_qw is not None else 1)
    flat_backbone = torch.from_numpy(
        b_codes_fwd.reshape(nb * Lpad).clip(0, 3)).to(dev)
    cap = max(1 << 12, nb * Lpad // 8)
    sym8, n_ins, packed = PU.consensus_and_insertions(
        merged[:size_all], flat_backbone, min_depth=min_depth,
        size_v=size_v, ins_slots=INS_SLOTS, cap=cap)
    sym_out = sym8.cpu().numpy().reshape(nb, Lpad)
    stride = 1 + INS_SLOTS
    if n_ins > cap:  # error-rate bound blown: dense path, never drop
        log.warning("insertion calls %d > cap %d — dense fallback",
                    n_ins, cap)
        _, depth = PU.consensus_call(merged[:size_v], flat_backbone,
                                     min_depth=min_depth)
        depth = depth.cpu().numpy().reshape(nb, Lpad)
        ins_votes = merged[size_v:size_all].cpu().numpy().reshape(
            nb, Lpad, INS_SLOTS, 4)
        ins_best = ins_votes.argmax(-1).astype(np.uint8)
        ins_cnt = ins_votes.max(-1)
        do_ins = ins_cnt >= np.maximum(min_depth,
                                       (depth + 1) // 2)[..., None]
        e_b, e_col, e_slot = np.nonzero(do_ins)
        e_base = ins_best[e_b, e_col, e_slot]
    else:
        sp = packed.cpu().numpy()
        flat = sp >> 2
        e_base = (sp & 3).astype(np.uint8)
        e_slot = flat % INS_SLOTS
        colf = flat // INS_SLOTS
        e_b = colf // Lpad
        e_col = colf % Lpad
    out: List[str] = []
    # per-read emission: base row from the symbol plane; insertion
    # positions filled from the sparse entries (sorted by read already)
    lo = np.searchsorted(e_b, np.arange(nb))
    hi = np.searchsorted(e_b, np.arange(nb), side="right")
    for i in range(nb):
        L = int(backbones.length[i])
        vals = np.zeros(stride * L, np.uint8)
        mask = np.zeros(stride * L, bool)
        vals[0::stride] = sym_out[i, :L].astype(np.uint8)
        mask[0::stride] = sym_out[i, :L] != 4
        sl = slice(lo[i], hi[i])
        # slot s is s-th from the run END: emit higher slots first
        pos = e_col[sl] * stride + 1 + (INS_SLOTS - 1 - e_slot[sl])
        keep = e_col[sl] < L
        vals[pos[keep]] = e_base[sl][keep]
        mask[pos[keep]] = True
        out.append(decode_bases(vals[mask]))
    return out


def correct_long_reads(pr_short: PackedReads, pr_long: PackedReads,
                       cfg: AssemblerConfig,
                       max_cols: int = MAX_VOTE_COLS, **kw) -> PackedReads:
    """Config-5 first half: hybrid error correction of long reads.

    cfg.corr_passes > 1 re-runs the whole consensus over the once-corrected
    reads.  Backbones are LENGTH-BUCKETED into groups whose (count x
    group_pad) vote footprint stays under max_cols, each corrected at its
    own pad.  Accepts consensus_backbones kwargs (device=..., min_score=...,
    solid=..., seed_index=..., mesh=...).  In a world of several ranks each
    rank corrects a contiguous block of every group's backbones on its own
    device and the corrected sequences are gathered back in rank order.
    """
    out = pr_long
    totals: dict = {}
    for p in range(max(1, cfg.corr_passes)):
        if p:
            log.info("correction pass %d/%d", p + 1, cfg.corr_passes)
        out = _correct_once(pr_short, out, cfg, max_cols,
                            suffix="_corr" if p == 0 else "", **kw)
        # sum the wall-clock split across passes
        for key, v in LAST_TIMINGS.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[key] = round(totals.get(key, 0) + v, 3)
    LAST_TIMINGS.update(totals)
    return out


def length_groups(lengths: np.ndarray, max_cols: int) -> List[np.ndarray]:
    """Backbone indices by ascending length, cut into groups whose count x
    group pad stays under max_cols (the order correction runs them in)."""
    groups: List[np.ndarray] = []
    cur: List[int] = []
    for i in np.argsort(lengths, kind="stable"):
        pad = ((max(int(lengths[i]), 32) + 31) // 32) * 32
        if cur and (len(cur) + 1) * pad > max_cols:
            groups.append(np.array(cur))
            cur = []
        cur.append(int(i))
    if cur:
        groups.append(np.array(cur))
    return groups


def _correct_once(pr_short: PackedReads, pr_long: PackedReads,
                  cfg: AssemblerConfig, max_cols: int, suffix: str = "_corr",
                  **kw) -> PackedReads:
    partition = HP.nproc() > 1
    if partition:
        kw = dict(kw, mesh=HP.local_mesh(kw.get("mesh")))
    n = pr_long.n_reads
    groups = length_groups(pr_long.length, max_cols)
    if partition:       # this rank's contiguous block of every group
        groups = [g[slice(*HP.block_range(len(g)))] for g in groups]
    whole = partition or len(groups) > 1

    t_idx0 = time.perf_counter()
    if whole and kw.get("seed_index") is None:
        from hga_tpu_torch.models.overlap_long import build_seed_index

        kw = dict(kw)
        kw["seed_index"] = build_seed_index(
            pr_short, cfg, solid=kw.get("solid"),
            device=kw.get("device", "cuda"))
    t_idx = time.perf_counter() - t_idx0

    # query the index ONCE for the whole long-read set and slice candidates
    # per group.  Split over ranks, each rank expands only its own
    # backbones, with every seed frequency still counted over the whole
    # set, so its candidates are the one-process run's (the reference
    # counts over the rank's block, which changes them)
    g_all = None
    t_gc0 = time.perf_counter()
    if whole:
        mine = np.sort(np.concatenate(groups)) if partition else None
        g_all = find_candidates_cross(
            pr_short, pr_long, cfg, solid=kw.get("solid"),
            seed_index=kw.get("seed_index"), device=kw.get("device", "cuda"),
            b_mine=mine)
    t_gc = time.perf_counter() - t_gc0

    corrected: List[Optional[str]] = [None] * n
    totals: dict = {"index_s": round(t_idx, 3), "gcand_s": round(t_gc, 3)}
    for g in groups:
        HP.note("corr_backbones", len(g))
        if len(g) == 0:
            continue
        pad_g = ((int(pr_long.length[g].max()) + 31) // 32) * 32
        sub = pr_long.subset(g).with_pad(pad_g)
        log.info("correction group: %d reads @ pad %d", len(g), pad_g)
        gkw = kw
        if g_all is not None:
            a_c, b_c, r_c, d_c = g_all
            inv = np.full(n, -1, np.int64)
            inv[g] = np.arange(len(g))
            bm = inv[b_c]
            m = bm >= 0
            gkw = dict(kw, cands=(a_c[m], bm[m].astype(b_c.dtype),
                                  r_c[m], d_c[m]))
        seqs = consensus_backbones(sub, pr_short, cfg, **gkw)
        for key, v in LAST_TIMINGS.items():   # sum the split across groups
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[key] = round(totals.get(key, 0) + v, 3)
        for i, s in zip(g, seqs):
            corrected[i] = s
    LAST_TIMINGS.update(totals)
    if partition:
        mine = [i for i in range(n) if corrected[i] is not None]
        g_idx, g_seqs = HP.allgather_indexed_strings(
            mine, [corrected[i] for i in mine])
        for i, s in zip(g_idx, g_seqs):
            corrected[int(i)] = s
    assert all(s is not None for s in corrected)
    # inserted bases can push a read past the original pad — re-derive it
    pad = max(pr_long.pad_len,
              ((max(len(s) for s in corrected) + 15) // 16) * 16)
    return pack_reads(corrected, names=[nm + suffix for nm in pr_long.names],
                      category=np.ones(len(corrected), np.int32),
                      pad_len=pad)


def polish_contigs(contigs: List[Tuple[str, str]], pr_short: PackedReads,
                   cfg: AssemblerConfig, **kw) -> List[Tuple[str, str]]:
    """Config-5 second half: polish assembled contigs with short reads.

    In a world of several ranks each rank polishes a contiguous block of
    the contigs on its own device (their candidates counted over every
    contig, as one process counts them); they are gathered back in
    order."""
    if not contigs:
        return []
    partition = HP.nproc() > 1
    idx = list(range(len(contigs)))
    if partition:
        kw = dict(kw, mesh=HP.local_mesh(kw.get("mesh")))
        b_lo, b_hi = HP.block_range(len(contigs))
        idx = idx[b_lo:b_hi]
    polished: List[str] = []
    if idx:
        seqs = [contigs[i][1] for i in idx]
        backbones = pack_reads(
            seqs, names=[contigs[i][0] for i in idx],
            category=np.ones(len(seqs), np.int32),
            pad_len=max(len(s) for s in seqs))
        if partition:
            every = pack_reads([s for _, s in contigs],
                               pad_len=max(len(s) for _, s in contigs))
            a, b, rel, diag = find_candidates_cross(
                pr_short, every, cfg, solid=kw.get("solid"),
                seed_index=kw.get("seed_index"),
                device=kw.get("device", "cuda"), b_mine=np.arange(b_lo, b_hi))
            kw = dict(kw, cands=(a, (b - b_lo).astype(b.dtype), rel, diag))
        polished = consensus_backbones(backbones, pr_short, cfg, **kw)
    if partition:
        g_idx, g_seqs = HP.allgather_indexed_strings(idx, polished)
        by_i = dict(zip((int(i) for i in g_idx), g_seqs))
        return [(contigs[i][0], by_i[i]) for i in range(len(contigs))]
    return [(contigs[i][0], s) for i, s in zip(idx, polished)]
