"""The port's kernel harnesses, one module per script of the repo's ``exp/``
that reaches a Pallas kernel (same file names):

  vpu_micro    X3: int32 add/max issue rate (csrc/vpu_micro.cu), and a bf16
               torch.matmul probe
  myers_micro  X1: Myers with targets staged in column slabs
               (csrc/myers_micro.cu), beside K1
  sw_variants  X2: anti-diagonal SW, a warp per pair, int32 / int16x2 / G
               pair groups (csrc/sw_variants.cu), beside K3

Each runs as ``python -m hga_tpu_torch.exp.<name>`` with the JAX script's
flags plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain
versions).
"""
