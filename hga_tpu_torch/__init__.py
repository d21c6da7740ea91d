"""hga_tpu_torch — the hybrid genome assembler on PyTorch and CUDA.

The PyTorch/CUDA counterpart of ``hga_tpu``: the same stages, artifacts and
config digests, with the two bit-parallel Myers kernels hand-written in CUDA
for Hopper (``csrc/myers.cu``).  Entry point: ``models.pipeline.run_pipeline``.
"""

__version__ = "0.1.0"
