"""Benchmark of hga_tpu_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

``BENCHMARK.json`` at the root of the repository names the cells; this
package finds everything that belongs to one of them by name:

- ``configs/<config>.json``: a deployment (genome, reads, settings);
- ``traffic/<mix>.json``: a traffic mix, data only, which names its jobs;
- ``jobs/<kind>.py``: the job of a kind of mix (the timed call into
  the program) and the check of its answers against a plain reference;
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per layer.

``gen.py`` makes the inputs from the seed, ``reference/`` holds the plain
references (NumPy and PyTorch, nothing of the program), ``roofline.py`` the
frozen peaks and operation counts, ``devtrace.py`` the reduction of a profiler
trace.  ``run.py`` is the command; ``control.py`` reads the comparison's
numbers for sound runs and for the control.
"""
