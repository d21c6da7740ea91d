"""Assembly evaluation — N50, genome fraction, identity (PyTorch port of
``hga_tpu.utils.evalx``).

The k-mer metrics (``evaluate_contigs``), ``n50`` and the contig-set diff
(``exact_contig_match``) are host numpy, as in the reference.  The two
alignment metrics run on a device (``device="cuda"`` unless the caller asks
for ``"cpu"``): ``alignment_identity`` through the long-read overlap engine
(models/overlap_long, K1'), ``segment_identity`` through K1''s shared-target
mode, every contig segment against one row that holds the genome and its
reverse complement.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from hga_tpu_torch.io.encode import encode_bases, revcomp_str


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


def evaluate_contigs(contigs: List[Tuple[str, str]], reference: str,
                     k: int = 21, circular: bool = False) -> Dict[str, float]:
    """Alignment-free evaluation: k-mer precision/recall vs the reference.

    identity  — fraction of contig k-mers present in the reference (strand
                agnostic): measures base accuracy + chimera-freeness.
    genome_fraction — fraction of reference k-mers covered by contigs.

    circular=True treats the reference as a circle: the k-1 origin-spanning
    k-mers join the reference set, so a correctly-assembled circular contig
    (an arbitrary rotation of the reference) scores identity 1.0.
    """
    if circular and len(reference) > k:
        reference = reference + reference[: k - 1]
    lengths = [len(s) for _, s in contigs]
    ref_canon = np.unique(_kmers_u64(reference, k, canonical=True))
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
    ref_fwd = np.unique(_kmers_u64(reference, k, canonical=False))
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


def segment_identity(contigs: List[Tuple[str, str]], reference: str,
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
    """
    import torch

    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.models.overlap import SENT_BASE, default_edit
    from hga_tpu_torch.parallel.mesh import pad_to_multiple
    from hga_tpu_torch.utils.device import resolve_device

    if not contigs:
        return dict(segment_identity=0.0, n_segments=0)
    dev = resolve_device(device)
    P = mesh.size if mesh is not None else 1
    # shared target: genome . sentinel . revcomp(genome), sentinel-padded
    # to a multiple of the mesh size (the ring's chunks)
    g_fwd, _ = encode_bases(reference)
    g_rc = 3 - g_fwd[::-1]
    t_true = len(g_fwd) * 2 + 1
    Lt = pad_to_multiple(t_true, P)
    t_row = np.full(Lt, SENT_BASE, np.int32)
    t_row[: len(g_fwd)] = g_fwd
    t_row[len(g_fwd) + 1 : t_true] = g_rc
    t1 = torch.from_numpy(t_row[None, :]).to(dev)

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
        qb, qlb = q[s0 : s0 + batch], ql[s0 : s0 + batch]
        pad = -qb.shape[0] % B
        qb = np.pad(qb, ((0, pad), (0, 0)), constant_values=SENT_BASE)
        qlb = np.pad(qlb, (0, pad))
        tlb = torch.full((qb.shape[0],), t_true, dtype=torch.int32,
                         device=dev)
        r = edit(torch.from_numpy(qb).to(dev), t1,
                 torch.from_numpy(qlb).to(dev), tlb)
        total_dist += int(r.dist.to(torch.int64).sum())
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
