"""L6 — distribution over torch.distributed (port of ``hga_tpu.parallel``).

One process per device: the port's "mesh" is the world of ranks, rank r
holding one device (``torchrun --nproc-per-node N``).

* ``mesh``        — init_distributed (torchrun's environment, the backend
  rule), Mesh, make_mesh / auto_mesh, shard_batch_fn, pad_to_multiple
* ``hostpart``    — host loops split by contiguous rank blocks, re-replicated
  by rank-ordered gathers (WORK counters, block_range, allgather_concat)
* ``collectives`` — owner-shard k-mer counting (all_to_all), the gathered
  count, and the one place that stages CUDA tensors through host memory
  for gloo
* ``ring_myers``  — the Myers DP with the target's columns split over the
  ranks and the column state handed rank to rank
* ``launch``      — start P rank processes with torchrun's environment
  (tests and chip_smoke.py; users run torchrun)
"""
