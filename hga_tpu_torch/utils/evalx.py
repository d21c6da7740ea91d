"""Assembly evaluation — N50, genome fraction, identity (PyTorch port of
``hga_tpu.utils.evalx``).

The k-mer metrics (``evaluate_contigs``), ``n50`` and the contig-set diff
(``exact_contig_match``) are host numpy, as in the reference.  The two
alignment metrics run on a device (``device="cuda"`` unless the caller asks
for ``"cpu"``): ``alignment_identity`` through the long-read overlap engine
(models/overlap_long, K1'), ``segment_identity`` through K1''s shared-target
mode, every contig segment against one row that holds the genome and its
reverse complement.

A reference is one sequence (``str``, one linear record, as in the JAX
package) or a sequence of records ``(name, seq, circular)``: a chromosome
and its plasmids, each judged on its own and a circular one across its
origin (``evaluate_contigs``, ``segment_identity``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from hga_tpu_torch.io.encode import encode_bases, revcomp_str
from hga_tpu_torch.utils import spans


def n50(lengths: Sequence[int]) -> int:
    ls = sorted((int(x) for x in lengths), reverse=True)
    total = sum(ls)
    acc = 0
    for l in ls:
        acc += l
        if acc * 2 >= total:
            return l
    return 0


def _kmers_u64(seq: str, k: int, canonical: bool) -> np.ndarray:
    """All k-mer values of seq as uint64 (k <= 31), vectorized.

    canonical=True returns min(value, revcomp value) per position; N-bearing
    k-mers are dropped."""
    from hga_tpu_torch.utils.oracle import kmer_values

    codes, bad = encode_bases(seq)
    if canonical:
        canon, _, valid = kmer_values(codes, bad, len(seq), k)
        return canon[valid]
    # forward-only values (same loop shape as the oracle)
    m = max(0, len(seq) - k + 1)
    if m == 0:
        return np.zeros(0, np.uint64)
    c64 = codes.astype(np.uint64)
    fwd = np.zeros(m, np.uint64)
    for t in range(k):
        fwd |= c64[t : t + m] << np.uint64(2 * (k - 1 - t))
    badc = np.concatenate([[0], np.cumsum(bad[: len(seq)], dtype=np.int64)])
    return fwd[(badc[k:] - badc[:-k]) == 0]


Record = Tuple[str, str, bool]          # (name, seq, circular)
Reference = Union[str, Sequence[Record]]


def evaluate_contigs(contigs: List[Tuple[str, str]], reference: Reference,
                     k: int = 21, circular: bool = False) -> Dict[str, float]:
    """Alignment-free evaluation: k-mer precision/recall vs the reference.

    identity  — fraction of contig k-mers present in the reference (strand
                agnostic): measures base accuracy + chimera-freeness.
    genome_fraction — fraction of reference k-mers covered by contigs.

    circular=True treats a ``str`` reference as a circle: the k-1
    origin-spanning k-mers join the reference set, so a correctly-assembled
    circular contig (an arbitrary rotation of the reference) scores
    identity 1.0.  A reference of records takes each record's k-mers on
    their own (none across two records), a circular record's with its k-1
    origin-spanning ones; `circular` is then not read.
    """
    if isinstance(reference, str):
        reference = [("", reference, circular)]
    seqs = [s + s[: k - 1] if circ and len(s) > k else s
            for _, s, circ in reference]

    def ref_kmers(canonical: bool) -> np.ndarray:
        return np.unique(np.concatenate(
            [_kmers_u64(s, k, canonical) for s in seqs]
            or [np.zeros(0, np.uint64)]))

    lengths = [len(s) for _, s in contigs]
    ref_canon = ref_kmers(True)
    hit = 0
    tot = 0
    contig_sets = []
    for _, s in contigs:
        ck = _kmers_u64(s, k, canonical=True)
        tot += ck.size
        idx = np.searchsorted(ref_canon, ck)
        idx = np.clip(idx, 0, max(ref_canon.size - 1, 0))
        if ref_canon.size:
            hit += int((ref_canon[idx] == ck).sum())
        contig_sets.append(np.unique(ck))
    contig_canon = (np.unique(np.concatenate(contig_sets)) if contig_sets
                    else np.zeros(0, np.uint64))
    # denominator: distinct FORWARD reference k-mers; one is covered iff its
    # canonical value appears in any contig (strand-agnostic)
    ref_fwd = ref_kmers(False)
    mask = np.uint64((1 << (2 * k)) - 1)
    rc = np.zeros_like(ref_fwd)
    v = ref_fwd.copy()
    for t in range(k):
        rc = (rc << np.uint64(2)) | (np.uint64(3) - (v & np.uint64(3)))
        v >>= np.uint64(2)
    ref_fwd_canon = np.minimum(ref_fwd, rc & mask)
    idx = np.searchsorted(contig_canon, ref_fwd_canon)
    idx = np.clip(idx, 0, max(contig_canon.size - 1, 0))
    covered = int((contig_canon[idx] == ref_fwd_canon).sum()) if (
        contig_canon.size) else 0
    return dict(
        n_contigs=len(contigs),
        total_len=int(sum(lengths)),
        n50=n50(lengths),
        longest=int(max(lengths) if lengths else 0),
        identity=hit / tot if tot else 0.0,
        genome_fraction=covered / ref_fwd.size if ref_fwd.size else 0.0,
    )


def exact_contig_match(contigs: List[Tuple[str, str]],
                       ref_contigs: List[Tuple[str, str]]) -> Dict:
    """Byte-for-byte contig-set comparison: contigs compare as unordered
    SETS of strand-canonical sequences (min(seq, revcomp(seq))) — naming and
    orientation are presentation; the bases are the contract."""
    ours = {min(s, revcomp_str(s)) for _, s in contigs}
    theirs = {min(s, revcomp_str(s)) for _, s in ref_contigs}
    return dict(
        exact_match=ours == theirs,
        n_ours=len(ours),
        n_ref=len(theirs),
        matched=len(ours & theirs),
        only_ours=len(ours - theirs),
        only_ref=len(theirs - ours),
    )


def segment_identity(contigs: List[Tuple[str, str]], reference: Reference,
                     seg: int = 384, batch: int = 4096,
                     device="cuda", mesh=None) -> Dict[str, float]:
    """Placement-free verification: every `seg`-sized contig segment's
    GLOBAL-best semi-global edit distance against the whole reference
    (both strands appended), summed into one identity number.

    Nothing is seeded: a segment that drifted, collapsed a repeat, or is
    chimeric still finds its best placement anywhere and pays its true edit
    cost.  The sweep is the overlap gate's edit engine
    (models/overlap.default_edit): on one device each batch of segments
    goes through K1''s shared-target mode (a (1, Lt) target); on a mesh of
    several ranks the reference's columns are split over the ranks and the
    DP streams through the ring engine (parallel/ring_myers.py, K1''s
    carried-state mode), each rank holding Lt / P columns.

    A reference is one sequence (``str``, one linear record, as the JAX
    package has it) or records ``(name, seq, circular)``, laid out by
    ``record_row``: a segment pays its best distance in any record on
    either strand, a circular record read across its origin, and a
    separator matches nothing.
    """
    with spans.span("evalseg.segment_identity"):
        return _segment_identity(contigs, reference, seg, batch, device, mesh)


def record_row(records: Sequence[Record], seg: int, P: int = 1
               ) -> Tuple[np.ndarray, int]:
    """The shared row of a reference of records: int32 codes, sentinel-
    padded to a multiple of P (the ring's chunks), and its true columns.

    The forward half takes the records in order, one SENT_BASE separator
    between two: each record's codes and, for a circular record, its first
    min(L, 2 seg - 1) bases again (the wrap).  The row is the forward half,
    one separator, then the forward half's reverse complement with its
    separators kept as separators; one linear record gives genome .
    sentinel . revcomp(genome).  The wrap is exact for a circular record of
    at least 2 seg - 1 bases: a segment of qlen <= seg bases has distance
    at most qlen, so an optimal alignment spans at most 2 qlen columns, and
    every such stretch of the circle, through the origin too, lies whole in
    the record and its wrap.
    """
    from hga_tpu_torch.models.overlap import SENT_BASE
    from hga_tpu_torch.parallel.mesh import pad_to_multiple

    if not records:
        raise ValueError("a reference of records needs at least one record")
    codes = [encode_bases(seq)[0] for _, seq, _ in records]
    wraps = [min(len(c), 2 * seg - 1) if circ else 0
             for c, (_, _, circ) in zip(codes, records)]
    half = sum(len(c) + w for c, w in zip(codes, wraps)) + len(codes) - 1
    t_true = 2 * half + 1
    row = np.full(pad_to_multiple(t_true, P), SENT_BASE, np.int32)
    o, seps = 0, []
    for c, w in zip(codes, wraps):
        row[o : o + len(c)] = c
        row[o + len(c) : o + len(c) + w] = c[:w]
        o += len(c) + w
        seps.append(o)                      # the separator stays SENT_BASE
        o += 1
    np.subtract(3, row[:half][::-1], out=row[half + 1 : t_true])
    # the forward separator at p lands at t_true - 1 - p on the reverse
    row[t_true - 1 - np.asarray(seps[:-1], np.int64)] = SENT_BASE
    return row, t_true


def _segment_identity(contigs, reference, seg, batch, device, mesh):
    import torch

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.models.overlap import SENT_BASE, default_edit
    from hga_tpu_torch.utils.device import resolve_device

    spans.count("evalseg.calls")
    if not contigs:
        return dict(segment_identity=0.0, n_segments=0)
    dev = resolve_device(device)
    P = mesh.size if mesh is not None else 1
    if isinstance(reference, str):
        reference = [("", reference, False)]
    with spans.span("evalseg.encode_reference"):
        # shared target: the records and their reverse complement, sentinel-
        # padded to a multiple of the mesh size (the ring's chunks)
        t_row, t_true = record_row(reference, seg, P)
    with spans.span("evalseg.h2d"):
        t1 = torch.from_numpy(t_row[None, :]).to(dev)
    h2d = t_row.nbytes

    with spans.span("evalseg.cut"):
        # cut contigs into fixed-width segments
        qs, ql = [], []
        for _, s in contigs:
            codes, _ = encode_bases(s)
            for o in range(0, len(s), seg):
                piece = codes[o : o + seg].astype(np.int32)
                row = np.full(seg, SENT_BASE, np.int32)
                row[: piece.size] = piece
                qs.append(row)
                ql.append(piece.size)
        q = np.stack(qs)
        ql = np.array(ql, np.int32)
    n_seg = q.shape[0]

    edit = default_edit(AssemblerConfig(), mesh)
    B = 1 if P == 1 else max(2 * P, 8)  # batches padded for the ring
    total_dist = 0
    for s0 in range(0, n_seg, batch):
        with spans.span("evalseg.h2d"):
            qb, qlb = q[s0 : s0 + batch], ql[s0 : s0 + batch]
            pad = -qb.shape[0] % B
            qb = np.pad(qb, ((0, pad), (0, 0)), constant_values=SENT_BASE)
            qlb = np.pad(qlb, (0, pad))
            tlb = torch.full((qb.shape[0],), t_true, dtype=torch.int32,
                             device=dev)
            args = (torch.from_numpy(qb).to(dev), t1,
                    torch.from_numpy(qlb).to(dev), tlb)
            h2d += qb.nbytes + qlb.nbytes
        with spans.span("evalseg.sweep"):
            r = edit(*args)
        del args            # the batch's codes leave before the next's come
        with spans.span("evalseg.reduce"):
            total_dist += int(r.dist.to(torch.int64).sum())
    spans.count("evalseg.h2d_bytes", h2d)
    span = int(ql.sum())
    return dict(segment_identity=1.0 - total_dist / max(span, 1),
                n_segments=int(n_seg), segment_dist=int(total_dist))


def alignment_identity(contigs: List[Tuple[str, str]], reference: str,
                       min_identity: float = 0.5,
                       device="cuda") -> Dict[str, float]:
    """TRUE alignment identity of each contig vs the reference genome.

    Reuses the long-read overlap engine (models/overlap_long.py): the
    reference genome is packed as read 0, every contig as a further read;
    anchor-chained segment edit distance gives per-contig dist/span.
    """
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.overlap_long import compute_overlaps_long

    if not contigs:
        return dict(aligned_fraction=0.0, alignment_identity=0.0)
    seqs = [reference] + [s for _, s in contigs]
    pad = ((max(len(s) for s in seqs) + 31) // 32) * 32
    pr = pack_reads(seqs, names=["ref"] + [n for n, _ in contigs],
                    pad_len=pad)
    cfg = AssemblerConfig(k=17, w=8, min_shared_minimizers=3,
                          min_overlap_len=64, min_identity=min_identity)
    ov = compute_overlaps_long(pr, cfg, device=device)
    # per contig: best (longest-span) alignment against read 0
    best_span = np.zeros(len(contigs), np.int64)
    best_dist = np.zeros(len(contigs), np.int64)
    for r in range(ov.n):
        if int(ov.a[r]) != 0:
            continue
        c = int(ov.b[r]) - 1
        span = int(ov.b_end[r] - ov.b_start[r])
        if span > best_span[c]:
            best_span[c] = span
            best_dist[c] = int(ov.dist[r])
    lens = np.array([len(s) for _, s in contigs], np.int64)
    aligned = best_span.sum() / max(lens.sum(), 1)
    ident = 1.0 - best_dist.sum() / max(best_span.sum(), 1)
    return dict(aligned_fraction=float(aligned),
                alignment_identity=float(max(ident, 0.0)))
