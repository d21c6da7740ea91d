"""Central configuration of the hybrid assembler (PyTorch port).

A field-for-field copy of ``hga_tpu.config.AssemblerConfig``: the same fields,
defaults and ``to_json``, so both packages serialise a config to the same
bytes and key their stage artifacts with the same digests (resume works across
the two packages).  ``mesh_shape``/``mesh_axes`` are carried for that reason
only; the port runs on one device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AssemblerConfig:
    # --- k-mer layer (L1) ---
    k: int = 21                    # judged config 1 uses k=21 (BASELINE.json)
    max_count: int = 255           # histogram clamp for the k-mer spectrum
    solid_threshold: int = 0       # 0 = auto (valley detection on the spectrum)

    # --- minimizer / seeding layer (L2) ---
    w: int = 11                    # minimizer window (w consecutive k-mers)
    # Repeat mask: drop minimizers occurring more often than this.  Must sit
    # WELL above read coverage (every genomic minimizer occurs ~coverage
    # times); the pipeline re-derives it as ~4x estimated coverage.
    max_seed_freq: int = 64
    min_shared_minimizers: int = 3 # candidate pair must share >= this many seeds

    # --- alignment layer (L3) ---
    band: int = 64                 # half-width of the SW band (cells each side)
    match: int = 2
    mismatch: int = -4
    gap: int = -3                  # linear gap penalty (all-integer DP)
    # Minimum accepted overlap span.  Must stay well below the short-read
    # length: with reads of length L and start rate lambda, every junction
    # whose start gap exceeds L - min_overlap_len breaks a contig, and the
    # break count grows exponentially in that margin.
    min_overlap_len: int = 32
    # Overlap acceptance identity: the Myers gate keeps a candidate iff
    # edit_distance / segment_len <= 1 - min_identity over the expected
    # overlap segment (models/overlap.py).
    min_identity: float = 0.70
    # Survivor coordinate refinement: "myers" derives end coords from the
    # gate's forward pass and start coords from ONE reversed bit-parallel
    # pass (~659 vs ~30 GCUPS — the round-2 verdict's refine-free option;
    # score = match * (span - dist), the long-read path's convention);
    # "sw" keeps the exact scored wavefront refine (local-SW trimmed
    # coordinates + DP score, two banded passes per survivor).
    overlap_refine: str = "myers"

    # --- graph layer (L4) ---
    min_overlap_score: int = 40
    # Graph-time overlap identity floor.  The DP gate's min_identity must
    # stay permissive (raw-read overlaps), but CORRECTED reads align at
    # ~0.997+, while overlaps BETWEEN different copies of a 99%-identity
    # repeat family sit near ~0.99 — a floor between the two keeps
    # repeat-crossing edges out of the string graph without touching the
    # alignment stage.  < 0 = AUTO (default): fit the valley between the
    # two modes of the overlap identity distribution when it is bimodal in
    # the corrected-read range (models/assembly.derive_graph_identity_floor)
    # — repeat-free runs are unimodal and get no floor.  0 = off; > 0 =
    # explicit floor.
    graph_min_identity: float = -1.0
    # Best-overlap branch pruning (models/assembly.prune_branch_edges): at
    # a branching node, drop out-edges whose overlap identity trails the
    # best branch by more than this margin (repeat copies diverge >= ~2x
    # (1 - family identity) >= 0.02; identity noise on a multi-kb overlap
    # is ~0.0015, so a trailing same-copy edge is never dropped in favor
    # of a cross-copy one).  Applies only to multi-kb corrected-read
    # overlaps; 0 = off.  Measured (1.5 Mb repeat model): 13 contigs ->
    # 1 contig at N50 1.50 Mb with margins 0.004-0.008; 0.008 is the
    # safer (less aggressive) end.
    graph_branch_margin: float = 0.008
    tip_max_len: int = 3           # tip clipping: max nodes in a clipped tip
    end_tol: int = 3               # bp floor when classifying dovetails
    # Length-aware end tolerance: an overlap's alignment may stop short of
    # the read ends by up to max(end_tol, hang_frac * read_len, capped at
    # 250 bp) and still classify as containment/dovetail — long noisy reads
    # carry unaligned end flanks the reference tolerates the same way
    # (SURVEY.md C10).  Junction extensions are corrected by the hang so
    # stitching stays exact.
    hang_frac: float = 0.02
    fuzz: int = 10                 # transitive-reduction length slack (floor;
    # auto-scaled to ~4% of the median non-contained read length)
    max_out_degree: int = 16       # neighbors inspected per edge in reduction
    min_contig_len: int = 0        # drop shorter contigs (0 = keep all)
    # Drop a contig when every one of its reads is >= this covered by
    # overlaps with reads already emitted in longer contigs: undetected
    # containments and tip/bubble orphans otherwise survive as duplicate
    # contigs (measured 57% of the genome covered twice at 1 Mb scale).
    redundant_cov: float = 0.95

    # --- correction / consensus layer (L5) ---
    min_pileup_depth: int = 2
    # Restrict seeds to SOLID k-mers (spectrum count >= threshold) where a
    # spectrum is available — the reference's discriminative-k-mer mechanism
    # (SURVEY.md C5/C12): error k-mers stop generating candidate pairs.
    use_solid_seeds: bool = True
    # Cap correction candidates at corr_depth_cap reads per (backbone,
    # ~read-length position bucket) — i.e. ~pileup depth per column.
    # 0 = AUTO: the pipeline derives ~0.7x the base coverage
    # estimated from the spectrum's coverage peak (models/pipeline.py);
    # direct consensus_backbones calls treat 0 as uncapped.  A pileup only
    # needs bounded depth; at judged scale (cov 30 x 20) the uncapped
    # alignment count dominates the wall clock.  Highest shared-seed-count
    # candidates win WITHIN each bucket (a global top-N leaves spatial
    # pileup holes — see overlap_long.py).
    corr_depth_cap: int = 0
    # Copy-aware correction (repeat resolution): a correction/polish
    # candidate must share >= 1 RARE seed (combined occurrence <=
    # corr_rare_seed_freq — single-locus frequency) with its backbone to
    # vote where anchored depth exists; candidates connected only through
    # seeds shared by 2-3 repeat copies (which slip under max_seed_freq)
    # are the family-averaging mechanism and are dropped wherever >=
    # corr_anchor_min anchored candidates cover the same positional bucket.
    # -1 = AUTO: the pipeline derives ~1.8x the spectrum coverage peak
    # (2-copy seeds sit at ~2x peak); 0 = off; > 0 = explicit cap.
    corr_rare_seed_freq: int = -1
    corr_anchor_min: int = 2
    # alignments per correction device batch (larger amortizes the lockstep
    # traceback scan; 4096 measured ~30% faster per-alignment than 1024)
    corr_batch_pairs: int = 1024
    # Correction DP engine: "myers" runs the bit-parallel planes kernel +
    # plane-based traceback (ops/myers_pallas + ops/pileup, ~20x the scored
    # DP's cell rate); "sw" keeps the scored dirs wavefront DP.  The Myers
    # gate accepts a read->backbone alignment iff edit_distance <=
    # (1 - min_identity) * read_len (full-query semi-global; SW clips tails
    # instead — consensus votes are majority-robust to the difference).
    corr_engine: str = "myers"
    # Quality-weighted consensus votes (FASTQ quality plane, SURVEY.md L0
    # per-read metadata).  Off by default: votes count 1 per covering read
    # (the parse-and-drop policy documented in io/fastq.py).  On, and when
    # the short reads carry a quality plane (PackedReads.qual), each vote
    # weighs its base's phred tier — 1 (q < 13), 2 (13 <= q < 28), 3
    # (q >= 28); deletion/insertion votes weigh the flanking read base.
    # Votes are then in weighted units and the consensus step scales the
    # min_pileup_depth floor x3 internally, so the configured value keeps
    # meaning "~this many confident reads" either way.  Requires
    # corr_engine="myers" (the production engine; validated at construction).
    use_quality: bool = False
    # Copy ARBITRATION (repeat resolution, models/arbitration.py): after
    # assembly and before polish, raw long reads — placed by their unique
    # flanking anchors — vote on the contigs, snapping family-averaged
    # repeat loci ("wrong islands", where short-read pileups cannot anchor
    # because the averaged backbone destroyed the rare seeds) back to the
    # true copy; polish then re-anchors there and locks the result.  Off
    # only for debugging: the pass is a no-op on repeat-free genomes
    # (votes agree with the backbone everywhere).
    arbitrate: bool = True
    # Depth floor for arbitration columns: with ~10%-error raw-long votes
    # a column needs this many covering chunks before argmax may override
    # the backbone (unique columns vote ~90% backbone anyway; the floor
    # guards low-coverage noise).
    arb_min_depth: int = 5
    # Correction passes: each pass can restore at most 3 consecutive
    # backbone-deleted bases (the pileup's insertion slots), so a >=4-base
    # nanopore deletion needs a second pass over the ONCE-corrected reads
    # (they become the new backbones).  1 = single pass (default; covers
    # the dominant 1-3 base deletions), n restores up to 3n-base gaps.
    corr_passes: int = 1
    # Same mechanism for contig polishing: pass 2 re-polishes the polished
    # contigs, recovering >3-base indel runs and re-voting columns whose
    # neighborhood changed in pass 1.
    polish_passes: int = 1

    # --- orchestration (L6) ---
    mesh_shape: Optional[Tuple[int, ...]] = None  # None = all local devices
    mesh_axes: Tuple[str, ...] = ("data",)
    batch_reads: int = 4096        # reads per device batch
    pad_len: int = 256             # short-read pad length (multiple of 16)

    # --- misc ---
    seed: int = 0
    dtype_score: str = "int32"

    def __post_init__(self):
        # fail fast at config construction, not deep inside the consensus
        # step after candidate generation already ran (round-3 advisor
        # item 3) — same message as the step-level guard
        if self.use_quality and self.corr_engine != "myers":
            raise ValueError(
                "use_quality requires corr_engine='myers' (the production "
                "engine); the scored-dirs engine is unweighted")
        if self.corr_engine not in ("myers", "sw"):
            raise ValueError(f"corr_engine must be 'myers' or 'sw', "
                             f"got {self.corr_engine!r}")
        if self.overlap_refine not in ("myers", "sw"):
            raise ValueError(f"overlap_refine must be 'myers' or 'sw', "
                             f"got {self.overlap_refine!r}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "AssemblerConfig":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(AssemblerConfig)}
        d = {k: v for k, v in d.items() if k in known}
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(d["mesh_shape"])
        d["mesh_axes"] = tuple(d.get("mesh_axes", ("data",)))
        if "min_identity" in d:
            d["min_identity"] = float(d["min_identity"])
        return AssemblerConfig(**d)

    def replace(self, **kw) -> "AssemblerConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = AssemblerConfig()
