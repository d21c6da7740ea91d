"""Plain references of the benchmark's comparisons.

NumPy and plain PyTorch only: nothing here imports the program
(``hga_tpu_torch``), the JAX package or JAX, and nothing takes what the
program made; each works its answer out again from the benchmark's inputs.
"""
