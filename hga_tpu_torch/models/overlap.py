"""Stage 3 (judged config 3) — overlap extension over candidate pairs
(PyTorch port of ``hga_tpu.models.overlap``).

Two passes over the candidates of the short-read route (``compute_overlaps``
for one read set, ``compute_overlaps_cross`` for short reads against long
reads — judged config 3):

1. **Myers gate**: every candidate's expected overlap segment, derived from
   the seed diagonal, runs through the unbanded bit-parallel edit distance
   (K1, ops/myers_cuda.py) against a target window with band/2 slack each
   side; a candidate survives iff the segment is long enough and
   dist <= (1 - min_identity) * segment_len.
2. **Refine** of the survivors' coordinates: ``overlap_refine="myers"`` runs
   one reversed Myers pass for the start coordinates (score = match *
   (span - dist)); ``"sw"`` runs the banded scored Smith-Waterman (K3,
   ops/align_cuda.py) forward for the score and end cell, then on the
   reversed matched prefixes at twice the band for the start cell.

The band is centred by construction: the target is re-oriented (reverse
complement when rel=1) and shifted by the candidate's estimated diagonal.
Batch prep is host numpy, copied from the reference; each DP batch is
shipped to the device, launched, and read back.

In a world of several ranks (parallel/), each rank gates and refines a
contiguous block of the candidate list on its own device; the records are
re-replicated by a rank-ordered gather, in the one-process order.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import PackedReads, unpack_codes
from hga_tpu_torch.ops.align import SWResult
from hga_tpu_torch.ops.align_cuda import banded_sw_batch_cuda
from hga_tpu_torch.ops.myers import MyersResult
from hga_tpu_torch.ops.myers_cuda import myers_batch_cuda
from hga_tpu_torch.parallel import hostpart as HP
from hga_tpu_torch.parallel.mesh import shard_batch_fn
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

SENT_BASE = 4  # padding base code: never matches a real base 0..3
BATCH_PAIRS = 4096  # candidate pairs per gate / refine launch

# wall-clock split of the last overlap run (same keys as the reference):
# gate vs refine seconds and pair counts
LAST_TIMINGS: Dict[str, float] = {}


def default_sw(cfg: AssemblerConfig, mesh=None):
    """Score-only SW dispatch: K3's wrapper, which launches the kernel for
    CUDA tensors and runs its plain version for CPU tensors.  On a mesh of
    several ranks each rank sweeps its block of the pair batch and a
    rank-ordered all_gather rebuilds it (parallel/mesh.shard_batch_fn)."""
    cache = {}

    def sw(q, t, ql, tl, band: int) -> SWResult:
        if band not in cache:
            def inner(q, t, ql, tl):
                return banded_sw_batch_cuda(q, t, ql, tl, band=band,
                                            match=cfg.match,
                                            mismatch=cfg.mismatch,
                                            gap=cfg.gap)

            cache[band] = shard_batch_fn(mesh, inner, 4, SWResult)
        return cache[band](q, t, ql, tl)

    return sw


def _edit_inner(q, t, ql, tl) -> MyersResult:
    i32 = lambda x: x.to(torch.int32).contiguous()
    return myers_batch_cuda(i32(q), i32(t), i32(ql), i32(tl))


# Target length from which a mesh run splits the target's COLUMNS over the
# ranks (the ring engine, parallel/ring_myers.py) instead of splitting the
# pair batch: each rank then holds Lt / P columns.
RING_MIN_LT = 1 << 16


def default_edit(cfg: AssemblerConfig, mesh=None,
                 ring_min_lt: int = RING_MIN_LT):
    """Edit-distance dispatch for the overlap gate: K1's wrapper, which
    launches the kernel for CUDA tensors and runs its plain version for CPU
    tensors.  On a mesh of several ranks, a shared one-row target or one of
    at least ring_min_lt columns goes through the ring engine (when Lt
    divides over the ranks and N over 2 P blocks); any other batch is split
    over the ranks (parallel/mesh.shard_batch_fn)."""
    sharded = shard_batch_fn(mesh, _edit_inner, 4, MyersResult)
    if mesh is None or mesh.size <= 1:
        return sharded
    from hga_tpu_torch.parallel.ring_myers import myers_ring

    P = mesh.size

    def edit(q, t, ql, tl) -> MyersResult:
        N, Lt = q.shape[0], t.shape[1]
        if (Lt % P == 0 and N % (2 * P) == 0
                and (t.shape[0] == 1 or Lt >= ring_min_lt)):
            return myers_ring(mesh, q, t, ql, tl)
        if t.shape[0] == 1:
            t = t.expand(N, Lt)
        return sharded(q, t, ql, tl)

    return edit


@dataclasses.dataclass
class OverlapRecords:
    """PAF-shaped overlaps.

    Coordinates are 0-based half-open in each read's FORWARD frame; rel=1
    means b maps reverse-complemented.  score is the DP score (all-integer);
    dist is the gate's unit-cost edit distance over the expected overlap
    segment (identity ~= 1 - dist / block_len).
    """

    a: np.ndarray
    b: np.ndarray
    rel: np.ndarray
    score: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray
    b_end: np.ndarray
    a_len: np.ndarray
    b_len: np.ndarray
    dist: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.dist is None:
            self.dist = np.zeros(self.a.shape[0], np.int32)

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    def identity(self) -> np.ndarray:
        """Per-record alignment identity estimate from the gate distance."""
        blk = np.maximum(np.maximum(self.a_end - self.a_start,
                                    self.b_end - self.b_start), 1)
        return np.clip(1.0 - self.dist / blk, 0.0, 1.0)

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @staticmethod
    def load(path: str) -> "OverlapRecords":
        from hga_tpu_torch.convert import load_overlaps

        return load_overlaps(path)

    def to_paf(self, names_a, names_b) -> str:
        lines = []
        for i in range(self.n):
            blk = max(int(self.a_end[i] - self.a_start[i]),
                      int(self.b_end[i] - self.b_start[i]))
            matches = max(blk - int(self.dist[i]), 0)
            lines.append("\t".join(map(str, [
                names_a[self.a[i]], self.a_len[i], self.a_start[i], self.a_end[i],
                "+-"[int(self.rel[i])],
                names_b[self.b[i]], self.b_len[i], self.b_start[i], self.b_end[i],
                matches, blk, 255,
                f"NM:i:{int(self.dist[i])}",
                f"AS:i:{int(self.score[i])}",
                f"de:f:{int(self.dist[i]) / max(blk, 1):.4f}",
            ])))
        return "\n".join(lines) + ("\n" if lines else "")


def _empty() -> OverlapRecords:
    z = np.zeros(0, np.int32)
    return OverlapRecords(z, z, z, z, z, z, z, z, z, z)


def _oriented_codes(codes: np.ndarray, lengths: np.ndarray,
                    flip: np.ndarray) -> np.ndarray:
    """Reverse-complement rows where flip, respecting true lengths."""
    n, L = codes.shape
    idx = (lengths.astype(np.int64)[:, None] - 1) - np.arange(L)[None, :]
    rc = np.where(idx >= 0,
                  np.take_along_axis(codes, np.clip(idx, 0, L - 1), 1),
                  SENT_BASE)
    rc = np.where(rc < 4, 3 - rc, SENT_BASE)
    return np.where(flip[:, None], rc, codes).astype(codes.dtype)


def _window_gather(codes_b: np.ndarray, lengths_b: np.ndarray,
                   off: np.ndarray, Wt: int) -> np.ndarray:
    """t_win[i, x] = codes_b[i, x + off[i]], out-of-range -> SENT_BASE."""
    n, L = codes_b.shape
    x = np.arange(Wt)[None, :] + off[:, None]
    valid = (x >= 0) & (x < lengths_b[:, None])
    xc = np.clip(x, 0, L - 1)
    out = np.take_along_axis(codes_b, xc, axis=1)
    out[~valid] = SENT_BASE
    return out


def _to_dev(dev: torch.device, *xs: np.ndarray):
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)
                 for x in xs)


def _myers_gate(q, la, lb, diag, t_gather, cfg, edit, Wt, dev):
    """Edit-distance gate over one candidate batch.

    q: (P, Lq) ORIENTED query codes (SENT past length); diag: expected
    a_pos - b_pos in the oriented frames.  The expected overlap segment of a
    is [max(0, diag), min(la, lb + diag)); it is clipped out of q and run
    through the unbanded bit-parallel edit distance against a target window
    with band/2 slack on each side.  Returns (result, seg_len, q_seg_start).
    """
    P, Lq = q.shape
    qs = np.clip(diag, 0, la)
    qe = np.maximum(np.minimum(la, lb + diag), qs)
    seg = (qe - qs).astype(np.int64)
    x = np.arange(Lq)[None, :]
    gidx = x + qs[:, None]
    q_seg = np.where(x < seg[:, None],
                     np.take_along_axis(q, np.clip(gidx, 0, Lq - 1), 1),
                     SENT_BASE)
    t_m = t_gather(qs - diag - cfg.band // 2)
    res = edit(*_to_dev(dev, q_seg, t_m, seg, np.full(P, Wt)))
    return res, seg, qs


def _gate_keep(res, seg, cfg):
    """Apply the edit-rate threshold to a gate batch; also returns the
    forward pass's target end column (1-based window coords), from which
    the "myers" refine derives b_end."""
    dist = res.dist.cpu().numpy().astype(np.int64)
    tend = res.tend.cpu().numpy().astype(np.int64)
    max_ed = np.floor((1.0 - cfg.min_identity) * seg).astype(np.int64)
    keep = (seg >= cfg.min_overlap_len) & (dist <= max_ed)
    return keep, dist, tend


def _rev_segment(q, qs, seg, Lq):
    """Row i reversed over its segment [qs_i, qs_i + seg_i), SENT past it."""
    x = np.arange(Lq)[None, :]
    ridx = (qs + seg)[:, None] - 1 - x
    out = np.where(x < seg[:, None],
                   np.take_along_axis(q, np.clip(ridx, 0, Lq - 1), 1),
                   SENT_BASE)
    return out.astype(np.int32)


def _myers_refine(q, qs, seg, dist, off_m, t_win, edit, Wt, dev):
    """Start coordinates via one reversed bit-parallel pass: the forward
    gate's tend is b_end; the same engine on reversed sequences yields
    b_start.  Returns (b_or_start, ok): b_or_start in oriented-target
    coordinates (off_m + Wt - tend_rev); ok requires the reversed pass to
    reproduce the forward edit distance."""
    P, Lq = q.shape
    q_rev = _rev_segment(q, qs, seg, Lq)
    t_rev = t_win[:, ::-1]
    res = edit(*_to_dev(dev, q_rev, t_rev, seg, np.full(P, Wt)))
    dist_r = res.dist.cpu().numpy().astype(np.int64)
    tend_r = res.tend.cpu().numpy().astype(np.int64)
    b_or_start = off_m + Wt - tend_r
    ok = (dist_r == dist) & (seg > 0)
    return b_or_start, ok


def _sw_refine(q, t_win, qlen, sw, cfg, dev):
    """Scored refine of one survivor batch: the forward banded SW gives the
    score and end cell; the reverse pass on the matched prefixes, at twice
    the band, gives the start cell.  The reversed path lives on diagonals
    (tend - qend) - c with c in [-band, band] and |tend - qend| <= band, so
    the 2 * band reverse band always contains it and the reverse score
    equals the forward one.  Returns (score, qstart, qend, tstart, tend,
    rscore) in window coordinates."""
    P, Lq = q.shape
    Wt = t_win.shape[1]
    host = lambda x: x.cpu().numpy()
    fwd = sw(*_to_dev(dev, q, t_win, qlen, np.full(P, Wt)), cfg.band)
    score, qend, tend = host(fwd.score), host(fwd.qend), host(fwd.tend)
    qidx = (qend[:, None] - 1) - np.arange(Lq)[None, :]
    qr = np.where(qidx >= 0,
                  np.take_along_axis(q, np.clip(qidx, 0, Lq - 1), 1),
                  SENT_BASE)
    tidx = (tend[:, None] - 1) - np.arange(Wt)[None, :]
    tr = np.where(tidx >= 0,
                  np.take_along_axis(t_win, np.clip(tidx, 0, Wt - 1), 1),
                  SENT_BASE)
    rev = sw(*_to_dev(dev, qr, tr, qend, tend), 2 * cfg.band)
    return (score, qend - host(rev.qend), qend, tend - host(rev.tend), tend,
            host(rev.score))


_FIELDS = ("a", "b", "rel", "score", "a_start", "a_end", "b_start", "b_end",
           "dist")


def _gate(cols, prep, cfg, edit, Wt, dev):
    """Run the gate over the candidates cols = (a, b, rel, diag) in
    batches; prep(sl) returns (q, la, lb, diag, t_gather) for a slice.
    Returns the survivors' a, b (int64), rel, diag, dist (int32) and the
    gate's tend, qs, seg."""
    parts = []
    for s in range(0, len(cols[0]), BATCH_PAIRS):
        q, la, lb, diag, gather = prep(slice(s, s + BATCH_PAIRS))
        res, seg, qs = _myers_gate(q, la, lb, diag, gather, cfg, edit, Wt,
                                   dev)
        keep, dist, tend = _gate_keep(res, seg, cfg)
        parts.append((keep, dist, tend, qs, seg))
    keep, dist, tend, qs, seg = (np.concatenate(x) for x in zip(*parts))
    a, b, rel, diag = cols
    return (a[keep].astype(np.int64), b[keep].astype(np.int64),
            rel[keep].astype(np.int32), diag[keep].astype(np.int32),
            dist[keep].astype(np.int32), tend[keep], qs[keep], seg[keep])


def _check_refine(cfg: AssemblerConfig) -> None:
    if cfg.overlap_refine not in ("myers", "sw"):
        raise ValueError(f"overlap_refine must be 'myers' or 'sw', "
                         f"got {cfg.overlap_refine!r}")


def _records(outs, len_a, len_b, t_gate, t_ref0, n0, n_f, what,
             partition: bool):
    """Concatenate the refine batches into OverlapRecords (gathered in rank
    order when `partition`; a rank without survivors still joins the
    gather) and record the gate/refine split in LAST_TIMINGS."""
    cat = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in outs.items()}
    if partition:
        cat = HP.allgather_concat(cat)
    rec = OverlapRecords(a_len=len_a[cat["a"]].astype(np.int32),
                         b_len=len_b[cat["b"]].astype(np.int32), **cat)
    t_ref = time.perf_counter() - t_ref0
    LAST_TIMINGS.update(gate_s=round(t_gate, 3), refine_s=round(t_ref, 3),
                        gate_pairs=n0, refine_pairs=n_f)
    log.info("%s: %d candidates -> %d overlaps "
             "(gate %.2fs on %d pairs, refine %.2fs on %d survivors)",
             what, n0, rec.n, t_gate, n0, t_ref, n_f)
    return rec


def compute_overlaps(
    pr: PackedReads,
    cands,
    cfg: AssemblerConfig,
    device="cuda",
    mesh=None,
) -> OverlapRecords:
    """Two-pass overlap engine over the candidates (models/seeding.py
    SeedingResult) of one read set: Myers edit-rate gate, then refine.

    In a world of several ranks each rank takes a contiguous block of the
    candidates (hostpart.block_range) on its own device, and the records
    are gathered back in rank order."""
    if cands.n_pairs == 0:
        return _empty()
    _check_refine(cfg)
    dev = resolve_device(device)
    partition = HP.nproc() > 1 and cands.n_pairs >= HP.nproc()
    if partition:
        lo, hi = HP.block_range(cands.n_pairs)
        cands = dataclasses.replace(
            cands, a=cands.a[lo:hi], b=cands.b[lo:hi], rel=cands.rel[lo:hi],
            diag=cands.diag[lo:hi], shared=cands.shared[lo:hi])
        mesh = HP.local_mesh(mesh)
    HP.note("gate_pairs", cands.n_pairs)
    sw = default_sw(cfg, mesh)
    edit = default_edit(cfg, mesh)

    codes = unpack_codes(pr.packed).astype(np.int32)  # (R, pad_len)
    # mask bases past each read's length so they can never match
    Lpad = codes.shape[1]
    codes[np.arange(Lpad)[None, :] >= pr.length[:, None]] = SENT_BASE
    lengths = pr.length.astype(np.int32)
    Lq = Lpad
    Wt = Lq + cfg.band + 8

    # ---- pass 1: bit-parallel Myers gate over every candidate ----
    def prep(sl):
        a = cands.a[sl].astype(np.int64)
        b = cands.b[sl].astype(np.int64)
        rel = cands.rel[sl].astype(np.int32)
        lb = lengths[b].astype(np.int64)
        t_or = _oriented_codes(codes[b], lengths[b], rel == 1)
        return (codes[a], lengths[a].astype(np.int64), lb,
                cands.diag[sl].astype(np.int64),
                lambda off: _window_gather(t_or, lb, off, Wt))

    t_gate0 = time.perf_counter()
    f_a, f_b, f_rel, f_diag, f_dist, f_tend, f_qs, f_seg = _gate(
        (cands.a, cands.b, cands.rel, cands.diag), prep, cfg, edit, Wt, dev)
    t_gate = time.perf_counter() - t_gate0
    n_f = f_a.shape[0]
    log.info("overlap gate: %d candidates -> %d pass edit-rate filter",
             cands.n_pairs, n_f)
    if n_f == 0 and not partition:
        return _empty()

    # ---- pass 2: survivor coordinates ----
    t_ref0 = time.perf_counter()
    outs = {k: [] for k in _FIELDS}
    for s in range(0, n_f, BATCH_PAIRS):
        sl = slice(s, s + BATCH_PAIRS)
        a, b, rel = f_a[sl], f_b[sl], f_rel[sl]
        dist = f_dist[sl]
        lb = lengths[b]
        t_or = _oriented_codes(codes[b], lb, rel == 1)
        if cfg.overlap_refine == "myers":
            diag, dist = f_diag[sl].astype(np.int64), dist.astype(np.int64)
            qs, seg = f_qs[sl], f_seg[sl]
            lb = lb.astype(np.int64)
            off_m = qs - diag - cfg.band // 2       # the gate's window base
            t_win = _window_gather(t_or, lb, off_m, Wt)
            b_or_start, ok = _myers_refine(codes[a], qs, seg, dist, off_m,
                                           t_win, edit, Wt, dev)
            b_or_start = np.clip(b_or_start, 0, lb)
            b_or_end = np.clip(off_m + f_tend[sl], b_or_start, lb)
            score = cfg.match * np.maximum(seg - dist, 0)
            keep = ok & (score >= cfg.min_overlap_score)
            a_start, a_end = qs, qs + seg
        else:
            # expected j - i = pos_b_oriented - pos_a = -diag: shift t so
            # the band is centred, keeping `band` slack to the left
            off = -f_diag[sl] - cfg.band // 2
            t_win = _window_gather(t_or, lb.astype(np.int64), off, Wt)
            score, a_start, a_end, tstart, tend, rscore = _sw_refine(
                codes[a], t_win, lengths[a], sw, cfg, dev)
            b_or_start, b_or_end = tstart + off, tend + off
            keep = ((score >= cfg.min_overlap_score)
                    & ((a_end - a_start) >= cfg.min_overlap_len)
                    & (rscore >= score))  # the reverse pass reproduces it
        b_fwd_start = np.where(rel == 1, lb - b_or_end, b_or_start)
        b_fwd_end = np.where(rel == 1, lb - b_or_start, b_or_end)
        for k, v in zip(_FIELDS, (a, b, rel, score, a_start, a_end,
                                  b_fwd_start, b_fwd_end, dist)):
            outs[k].append(v[keep].astype(np.int32))
    return _records(outs, lengths, lengths, t_gate, t_ref0, cands.n_pairs,
                    n_f, "overlap", partition)


def compute_overlaps_cross(
    pr_a: PackedReads,
    pr_b: PackedReads,
    cfg: AssemblerConfig,
    device="cuda",
    mesh=None,
) -> OverlapRecords:
    """Judged config 3: overlaps between two read sets (short reads as
    queries `a`, long reads as targets `b`).

    Cross-category candidates come from models/correction
    .find_candidates_cross; each runs the same two passes as
    compute_overlaps.  b coordinates are in the long read's forward frame;
    the short READ is reverse-complemented for rel=1 so alignments share
    the target's forward context.  In a world of several ranks the
    candidate list is split as in compute_overlaps.
    """
    from hga_tpu_torch.models.correction import find_candidates_cross

    _check_refine(cfg)
    dev = resolve_device(device)
    a, b, rel, diag = find_candidates_cross(pr_a, pr_b, cfg, device=dev)
    if len(a) == 0:
        return _empty()
    partition = HP.nproc() > 1 and len(a) >= HP.nproc()
    if partition:
        lo, hi = HP.block_range(len(a))
        a, b, rel, diag = a[lo:hi], b[lo:hi], rel[lo:hi], diag[lo:hi]
        mesh = HP.local_mesh(mesh)
    sw = default_sw(cfg, mesh)
    edit = default_edit(cfg, mesh)

    a_codes = unpack_codes(pr_a.packed).astype(np.int32)
    Lq = a_codes.shape[1]
    a_codes[np.arange(Lq)[None, :] >= pr_a.length[:, None]] = SENT_BASE
    b_codes = unpack_codes(pr_b.packed).astype(np.int32)
    Lb = b_codes.shape[1]
    b_codes[np.arange(Lb)[None, :] >= pr_b.length[:, None]] = SENT_BASE
    b_flat = b_codes.reshape(-1)
    Wt = Lq + cfg.band + 8

    def b_gather(bb, lb, off):
        pos_f = np.arange(Wt)[None, :] + off[:, None]
        in_range = (pos_f >= 0) & (pos_f < lb[:, None])
        vals = b_flat[bb[:, None] * Lb + np.clip(pos_f, 0, Lb - 1)]
        return np.where(in_range, vals, SENT_BASE).astype(np.int32)

    def oriented(aa, bb, rr, dd):
        """Oriented short reads and the long-read forward position of their
        base 0 (seed algebra)."""
        la = pr_a.length[aa].astype(np.int64)
        lb = pr_b.length[bb].astype(np.int64)
        flip = rr == 1
        q = _oriented_codes(a_codes[aa], la, flip).astype(np.int32)
        base_off = np.where(flip, dd + lb - la, -dd).astype(np.int64)
        return q, la, lb, flip, base_off

    # ---- pass 1: Myers gate ----
    def prep(sl):
        bb = b[sl].astype(np.int64)
        q, la, lb, _, base_off = oriented(
            a[sl].astype(np.int64), bb, rel[sl].astype(np.int32),
            diag[sl].astype(np.int64))
        # oriented a_pos i sits at b forward pos i + base_off; the gate's
        # diag follows the a_pos - b_pos convention
        return q, la, lb, -base_off, lambda off: b_gather(bb, lb, off)

    n0 = len(a)
    t_gate0 = time.perf_counter()
    f_a, f_b, f_rel, f_diag, f_dist, f_tend, f_qs, f_seg = _gate(
        (a, b, rel, diag), prep, cfg, edit, Wt, dev)
    t_gate = time.perf_counter() - t_gate0
    n_f = f_a.shape[0]
    log.info("overlap-cross gate: %d candidates -> %d pass edit-rate filter",
             n0, n_f)
    if n_f == 0 and not partition:
        return _empty()

    # ---- pass 2: survivor coordinates ----
    t_ref0 = time.perf_counter()
    outs = {k: [] for k in _FIELDS}
    for s in range(0, n_f, BATCH_PAIRS):
        sl = slice(s, s + BATCH_PAIRS)
        aa, bb, rr = f_a[sl], f_b[sl], f_rel[sl]
        dist = f_dist[sl]
        q, la, lb, flip, base_off = oriented(
            aa, bb, rr, f_diag[sl].astype(np.int64))
        if cfg.overlap_refine == "myers":
            dist = dist.astype(np.int64)
            qs, seg = f_qs[sl], f_seg[sl]
            # the gate ran with diag = -base_off: off_m = qs - diag - band/2
            off_m = qs + base_off - cfg.band // 2
            t_win = b_gather(bb, lb, off_m)
            b_start, ok = _myers_refine(q, qs, seg, dist, off_m, t_win,
                                        edit, Wt, dev)
            b_start = np.clip(b_start, 0, lb)
            b_end = np.clip(off_m + f_tend[sl], b_start, lb)
            q_start, q_end = qs, qs + seg
            score = cfg.match * np.maximum(seg - dist, 0)
            keep = ok & (score >= cfg.min_overlap_score)
        else:
            off = base_off - cfg.band // 2
            t_win = b_gather(bb, lb, off)
            score, q_start, q_end, t_start, t_end, rscore = _sw_refine(
                q, t_win, pr_a.length[aa], sw, cfg, dev)
            b_start, b_end = t_start + off, t_end + off
            keep = ((score >= cfg.min_overlap_score)
                    & ((q_end - q_start) >= cfg.min_overlap_len)
                    & (rscore >= score))
        # oriented-a coordinates -> the read's forward frame
        a_start = np.where(flip, la - q_end, q_start)
        a_end = np.where(flip, la - q_start, q_end)
        for k, v in zip(_FIELDS, (aa, bb, rr, score, a_start, a_end,
                                  b_start, b_end, dist)):
            outs[k].append(v[keep].astype(np.int32))
    return _records(outs, pr_a.length, pr_b.length, t_gate, t_ref0, n0, n_f,
                    "overlap-cross", partition)
