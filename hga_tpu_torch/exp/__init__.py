"""The port's counterparts of the repo's ``exp/`` scripts (same file names).

The kernel harnesses, one a Pallas kernel of ``exp/``:

  vpu_micro    X3: int32 add/max issue rate (csrc/vpu_micro.cu), and a bf16
               torch.matmul probe
  myers_micro  X1: Myers from query planes, a pair split across lanes,
               target slabs staged by asynchronous copies
               (csrc/myers_micro.cu), beside K1
  sw_variants  X2: anti-diagonal SW over the band window, int32 / int16x2 /
               G pairs a warp (csrc/sw_variants.cu), beside K3

The judged-scale scripts and the truth-labelled diagnostics:

  scale_run          the judged pipeline on a simulated genome
                     (scale_metrics.json); holds the read model and the
                     judged config
  count_scale        judged config 1, k = 21 counting, timed twice
  reoverlap          long overlaps and assembly from a run's corrected.npz
  polish_retry       N polish passes over a run's contigs.fasta
  asm_sweep          nine assembly variants from a run's artifacts
  bench_corr_tb      correction's device path: K2, then K2' with and
                     without the walk bound
  diag_repeat_corr   candidate misplacement and copy-distinguishing sites
                     on a repeat genome
  diag_leak          the copy-aware filter's surviving misplaced candidates
  diag_polish_votes  polish votes at rRNA copy-distinguishing sites
  diag_false_ov      a run's overlaps, true and false by the reads' loci
  diag_graph         a run's string graph, stage by stage

Each runs as ``python -m hga_tpu_torch.exp.<name>`` with the JAX script's
arguments plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain
versions), and writes the JAX script's keys to the same files.
"""
