"""The hybrid pipeline with resume (PyTorch port of
``hga_tpu.models.pipeline``, judged config 5):

  1. k-mer spectrum on short reads (config 1)       -> spectrum.npz
  2. hybrid correction of long reads (config 5a)    -> corrected.npz
  3. overlaps of the assembled reads                -> overlaps.npz
     long reads (pad > 1024): anchor chains + segment DPs (K1)
     short reads (pad <= 1024, e.g. short-read-only input): candidates
     (config 2, -> candidates.npz), then the Myers gate (K1) and the
     refine (K3 when overlap_refine="sw")
  4. string graph -> contigs (config 4)             -> contigs.fasta / .gfa
  5. copy arbitration of contigs by the raw long    -> arbitrated.fasta
     reads (cfg.arbitrate, with long reads; K2')
  6. short-read polish of contigs (config 5b)       -> polished.fasta

Every stage writes the reference's artifact under the reference's
config+input digest, so ``resume=True`` skips stages whose artifact matches —
including artifacts the JAX package wrote (loaded through convert.py).

One device a process.  Under ``torchrun --nproc-per-node N`` the mesh is the
world of ranks (parallel/): counting is split by owner shard, correction,
overlaps and polish by contiguous rank blocks (gathered back in order),
arbitration's votes are summed over the ranks, and only rank 0 writes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hga_tpu_torch import convert
from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import PackedReads, pack_reads
from hga_tpu_torch.io.fastq import iter_records, read_sequence_files, write_fasta
from hga_tpu_torch.models import arbitration as ARB
from hga_tpu_torch.models.assembly import assemble
from hga_tpu_torch.models.correction import (LAST_TIMINGS as CT,
                                             correct_long_reads,
                                             polish_contigs)
from hga_tpu_torch.models.overlap import (LAST_TIMINGS as OV_TIMINGS,
                                          compute_overlaps)
from hga_tpu_torch.models.seeding import find_candidates
from hga_tpu_torch.models.spectrum import count_reads
from hga_tpu_torch.parallel import hostpart as HP
from hga_tpu_torch.parallel.mesh import auto_mesh
from hga_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# assembled reads padded longer than this take the long-read overlap route;
# the reference's threshold (hga_tpu/ops/align_pallas.MAX_QUERY_LEN)
LONG_READ_PAD = 1024


def _round16(n: int) -> int:
    return max(16, ((n + 15) // 16) * 16)


# which route the last load_reads took: route "native" or "python", and
# why the Python reader ran
LAST_LOAD: dict = {}


def _load_native(paths: Sequence[str], pad: int, category: int
                 ) -> Optional[PackedReads]:
    """Stream files through the C++ parser/packer (io/native)."""
    from hga_tpu_torch.io import native as NV

    packed, bad, lengths, names = [], [], [], []
    for p in paths:
        for pk, bd, ln, nm in NV.read_packed_batches(p, pad):
            packed.append(pk)
            bad.append(bd)
            lengths.append(ln)
            names.extend(nm)
    if not packed:
        return None
    n = sum(x.shape[0] for x in packed)
    return PackedReads(
        packed=np.concatenate(packed), bad=np.concatenate(bad),
        length=np.concatenate(lengths), names=names,
        category=np.full(n, category, np.int32), pad_len=pad)


def _load_python(short_paths: Sequence[str], long_paths: Sequence[str],
                 short_pad: Optional[int], long_pad: Optional[int],
                 keep_quality: bool
                 ) -> Tuple[Optional[PackedReads], Optional[PackedReads]]:
    """The pure-Python reader (two passes over lengths)."""
    shorts, snames, squals, longs, lnames, lquals = [], [], [], [], [], []
    for rec in read_sequence_files(list(short_paths) + list(long_paths),
                                   categories=[0] * len(short_paths)
                                   + [1] * len(long_paths)):
        if rec.category == 0:
            shorts.append(rec.seq)
            snames.append(rec.name)
            squals.append(rec.quality)
        else:
            longs.append(rec.seq)
            lnames.append(rec.name)
            lquals.append(rec.quality)
    pr_s = pr_l = None
    if shorts:
        pad = short_pad or _round16(max(len(s) for s in shorts))
        pr_s = pack_reads(shorts, names=snames, pad_len=pad,
                          quals=squals if keep_quality else None)
    if longs:
        pad = long_pad or _round16(max(len(s) for s in longs))
        keep_lq = keep_quality and any(q is not None for q in lquals)
        pr_l = pack_reads(longs, names=lnames,
                          category=[1] * len(longs), pad_len=pad,
                          quals=lquals if keep_lq else None)
    return pr_s, pr_l


def load_reads(
    short_paths: Sequence[str] = (),
    long_paths: Sequence[str] = (),
    short_pad: Optional[int] = None,
    long_pad: Optional[int] = None,
    keep_quality: bool = False,
) -> Tuple[Optional[PackedReads], Optional[PackedReads]]:
    """Stream FASTQ/FASTA files into packed short/long read batches.

    When the pads are known up front (short_pad, and long_pad whenever long
    files are given) and the native C++ parser built, the packing runs in
    native code (one pass, no Python string objects); otherwise the
    pure-Python reader runs.  keep_quality=True keeps the FASTQ quality
    plane (PackedReads.qual) and always takes the Python reader.
    LAST_LOAD records the route taken.
    """
    from hga_tpu_torch.io import native as NV

    if keep_quality:
        why = "keep_quality"
    elif short_pad is None or (long_paths and long_pad is None):
        why = "pads not given"
    elif not NV.available():
        why = f"native reader unavailable: {NV.UNAVAILABLE}"
    else:
        pr_s = _load_native(short_paths, short_pad, 0) if short_paths \
            else None
        pr_l = _load_native(long_paths, long_pad, 1) if long_paths else None
        LAST_LOAD.clear()
        LAST_LOAD.update(route="native")
        return pr_s, pr_l
    out = _load_python(short_paths, long_paths, short_pad, long_pad,
                       keep_quality)
    LAST_LOAD.clear()
    LAST_LOAD.update(route="python", why=why)
    return out


def _inputs_digest(pr_short: Optional[PackedReads],
                   pr_long: Optional[PackedReads]) -> str:
    """Content hash of the packed input reads (the reference's digest):
    different reads with the same counts never match a stale artifact."""
    h = hashlib.sha256()
    for pr in (pr_short, pr_long):
        if pr is None:
            h.update(b"none")
            continue
        h.update(np.ascontiguousarray(pr.packed).tobytes())
        h.update(np.ascontiguousarray(pr.length).tobytes())
        if pr.qual is not None:  # quality plane feeds weighted consensus
            h.update(np.ascontiguousarray(pr.qual).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class PipelineResult:
    contigs: List[Tuple[str, str]]
    polished: List[Tuple[str, str]]
    stats: Dict


class _Stage:
    """Artifact-checkpointed stage runner with digest-based resume."""

    def __init__(self, outdir: str, resume: bool, cfg: AssemblerConfig):
        self.outdir = outdir
        self.resume = resume
        self.digest = hashlib.sha256(cfg.to_json().encode()).hexdigest()[:16]
        self.stats: Dict = {"stages": {}}
        os.makedirs(outdir, exist_ok=True)

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.outdir, f"{name}.meta.json")

    def fresh(self, name: str, inputs_digest: str = "") -> bool:
        if not self.resume:
            return False
        try:
            with open(self._meta_path(name)) as fh:
                meta = json.load(fh)
            return (meta.get("config") == self.digest
                    and meta.get("inputs") == inputs_digest)
        except (OSError, json.JSONDecodeError):
            return False

    def done(self, name: str, t0: float, inputs_digest: str = "") -> None:
        dt = time.perf_counter() - t0
        self.stats["stages"][name] = {"seconds": round(dt, 3)}
        if HP.is_main():  # one writer per (possibly shared) outdir
            with open(self._meta_path(name), "w") as fh:
                json.dump({"config": self.digest, "inputs": inputs_digest,
                           "seconds": dt}, fh)
        log.info("stage %s: %.2fs", name, dt)


def run_pipeline(
    pr_short: Optional[PackedReads],
    pr_long: Optional[PackedReads],
    cfg: AssemblerConfig,
    outdir: str,
    resume: bool = False,
    device="cuda",
    mesh="auto",
) -> PipelineResult:
    """Full hybrid pipeline on `device` (``"cuda"`` unless the caller asks
    for ``"cpu"``; CUDA without a GPU raises).  mesh: "auto" takes the
    world of ranks when there are several (parallel/mesh.auto_mesh), None
    forces the one-device path, or pass a parallel.mesh.Mesh.  With
    several ranks resume is off and only rank 0 writes."""
    dev = resolve_device(device)
    if mesh == "auto":
        mesh = auto_mesh()
    if HP.nproc() > 1 and resume:
        # each rank holds different partial work, so a stage's artifact
        # cannot be known fresh on every rank at once
        log.warning("multi-process run: disabling --resume")
        resume = False
    main = HP.is_main()
    if mesh is not None:
        log.info("pipeline: mesh of %d ranks", mesh.size)
    st = _Stage(outdir, resume, cfg)
    t_all = time.perf_counter()
    inputs = _inputs_digest(pr_short, pr_long)
    path = lambda f: os.path.join(outdir, f)

    # --- stage: spectrum (config 1) ---
    spec = None
    cfg_corr = None
    if pr_short is not None:
        if st.fresh("spectrum", inputs) and os.path.exists(path("spectrum.npz")):
            spec = convert.load_spectrum(path("spectrum.npz"))
        else:
            t0 = time.perf_counter()
            spec = count_reads(pr_short, cfg, device=dev, mesh=mesh)
            if main:
                spec.save(path("spectrum.npz"))
            st.done("spectrum", t0, inputs)
        st.stats["spectrum"] = {"distinct": spec.n_distinct,
                                "threshold": spec.threshold}
        # derive the repeat mask cap from estimated coverage: the spectrum's
        # coverage peak ~ per-base read coverage of the k-mer plane
        hist = spec.hist
        if hist.size > 4 and cfg.solid_threshold == 0:
            peak = int(np.argmax(hist[spec.threshold:]) + spec.threshold)
            cap = max(cfg.max_seed_freq, 4 * peak)
            if cap != cfg.max_seed_freq:
                log.info("raising max_seed_freq %d -> %d (coverage peak %d)",
                         cfg.max_seed_freq, cap, peak)
                cfg = cfg.replace(max_seed_freq=cap)
            # correction depth cap ~0.7x base coverage (correction only;
            # polish keeps full depth)
            if cfg.corr_depth_cap == 0 and pr_long is not None:
                mean_l = float(pr_short.length.mean())
                base_cov = peak * mean_l / max(mean_l - cfg.k + 1, 1.0)
                dcap = max(8, int(np.ceil(0.7 * base_cov)))
                log.info("deriving corr_depth_cap %d (coverage peak %d)",
                         dcap, peak)
                cfg_corr = cfg.replace(corr_depth_cap=dcap)
            # copy-aware candidate filter: rare = single-locus seed frequency
            if cfg.corr_rare_seed_freq < 0:
                rcap = int(np.ceil(1.8 * peak))
                log.info("deriving corr_rare_seed_freq %d "
                         "(coverage peak %d)", rcap, peak)
                cfg = cfg.replace(corr_rare_seed_freq=rcap)
                cfg_corr = (cfg_corr or cfg).replace(
                    corr_rare_seed_freq=rcap)

    solid = spec.solid_set() if spec is not None else None
    if cfg_corr is None:
        cfg_corr = cfg

    # ONE short-read seed index shared by correction and polish, built
    # lazily by whichever stage needs it first
    _sidx: Dict = {}

    def short_seed_index():
        if pr_short is None:
            return None
        if "v" not in _sidx:
            from hga_tpu_torch.models.overlap_long import build_seed_index

            t_i0 = time.perf_counter()
            _sidx["v"] = build_seed_index(pr_short, cfg, solid=solid,
                                          device=dev)
            st.stats["seed_index_s"] = round(time.perf_counter() - t_i0, 3)
        return _sidx["v"]

    # --- stage: correction (config 5a) ---
    asm_reads = pr_short
    if pr_long is not None:
        if st.fresh("corrected", inputs) and os.path.exists(
                path("corrected.npz")):
            asm_reads = convert.load_corrected(path("corrected.npz"))
        else:
            t0 = time.perf_counter()
            if pr_short is not None:
                asm_reads = correct_long_reads(
                    pr_short, pr_long, cfg_corr, device=dev, solid=solid,
                    seed_index=short_seed_index(), mesh=mesh)
            else:
                asm_reads = pr_long
            if main:
                asm_reads.save(path("corrected.npz"))
            st.done("corrected", t0, inputs)
            st.stats["correction_detail"] = dict(CT)
    if asm_reads is None:
        raise ValueError("no reads given")

    ov_timings: Dict = {}
    if asm_reads.pad_len > LONG_READ_PAD:
        # --- stage: long overlaps (anchor chaining + segment DPs, K1) ---
        if st.fresh("overlaps", inputs) and os.path.exists(
                path("overlaps.npz")):
            ov = convert.load_overlaps(path("overlaps.npz"))
        else:
            from hga_tpu_torch.models import overlap_long as OL

            t0 = time.perf_counter()
            ov = OL.compute_overlaps_long(asm_reads, cfg, device=dev,
                                          mesh=mesh)
            ov_timings = dict(OL.LAST_TIMINGS)
            if main:
                ov.save(path("overlaps.npz"))
            st.done("overlaps", t0, inputs)
    else:
        # --- stage: candidates (config 2) ---
        if st.fresh("candidates", inputs) and os.path.exists(
                path("candidates.npz")):
            cands = convert.load_candidates(path("candidates.npz"))
        else:
            t0 = time.perf_counter()
            # solid-seed masking applies when assembling the short reads
            # directly; corrected long reads keep all seeds
            cands = find_candidates(
                asm_reads, cfg, solid=solid if pr_long is None else None,
                device=dev)
            if main:
                cands.save(path("candidates.npz"))
            st.done("candidates", t0, inputs)
        st.stats["candidates"] = {"n": cands.n_pairs}

        # --- stage: overlaps (config 3: Myers gate + refine) ---
        if st.fresh("overlaps", inputs) and os.path.exists(
                path("overlaps.npz")):
            ov = convert.load_overlaps(path("overlaps.npz"))
        else:
            t0 = time.perf_counter()
            ov = compute_overlaps(asm_reads, cands, cfg, device=dev,
                                  mesh=mesh)
            ov_timings = dict(OV_TIMINGS)
            if main:
                ov.save(path("overlaps.npz"))
            st.done("overlaps", t0, inputs)
    st.stats["overlaps"] = {"n": ov.n, **ov_timings}

    # --- stage: assembly (config 4) ---
    if st.fresh("assembly", inputs) and os.path.exists(path("contigs.fasta")):
        contigs = [(r.name, r.seq) for r in iter_records(path("contigs.fasta"))]
    else:
        t0 = time.perf_counter()
        res = assemble(asm_reads, ov, cfg, device=dev)
        contigs = res.contigs
        if main:
            write_fasta(path("contigs.fasta"), res.contigs)
            with open(path("assembly.gfa"), "w") as fh:
                fh.write(res.to_gfa(asm_reads.names, asm_reads.length))
        st.done("assembly", t0, inputs)
        st.stats["assembly"] = {
            "contigs": len(res.contigs),
            "edges_raw": res.n_edges_raw,
            "edges_reduced": res.n_edges_reduced,
            "contained": res.n_contained,
            "identity_floor": res.identity_floor,
        }

    # --- stage: arbitration (repeat resolution, models/arbitration.py) ---
    # raw long reads, placed by their unique flanking anchors, vote on the
    # contigs to snap family-averaged repeat loci to the true copy BEFORE
    # short-read polish re-anchors and locks them
    if cfg.arbitrate and pr_long is not None and contigs:
        if st.fresh("arbitrate", inputs) and os.path.exists(
                path("arbitrated.fasta")):
            contigs = [(r.name, r.seq)
                       for r in iter_records(path("arbitrated.fasta"))]
        else:
            t0 = time.perf_counter()
            contigs = ARB.arbitrate_contigs(contigs, pr_long, cfg,
                                            device=dev, mesh=mesh)
            if main:
                write_fasta(path("arbitrated.fasta"), contigs)
            st.done("arbitrate", t0, inputs)
            st.stats["arbitrate_detail"] = dict(ARB.LAST_TIMINGS)

    # --- stage: polish (config 5b) ---
    polished = contigs
    if pr_short is not None and contigs:
        t0 = time.perf_counter()
        pol_tot: Dict = {}
        for p in range(max(1, cfg.polish_passes)):
            if p:
                log.info("polish pass %d/%d", p + 1, cfg.polish_passes)
            polished = polish_contigs(polished, pr_short, cfg, device=dev,
                                      solid=solid, mesh=mesh,
                                      seed_index=short_seed_index())
            for key, v in CT.items():  # sum the split across passes
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    pol_tot[key] = round(pol_tot.get(key, 0) + v, 3)
        if main:
            write_fasta(path("polished.fasta"), polished)
        st.done("polish", t0, inputs)
        st.stats["polish_detail"] = pol_tot

    st.stats["total_seconds"] = round(time.perf_counter() - t_all, 3)
    st.stats["config"] = json.loads(cfg.to_json())
    if main:
        with open(path("run_metrics.json"), "w") as fh:
            json.dump(st.stats, fh, indent=2)
    return PipelineResult(contigs=contigs, polished=polished,
                          stats=st.stats)
