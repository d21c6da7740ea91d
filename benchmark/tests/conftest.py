"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository (a test marked ``cuda`` skips without a
card).  The repository's root goes first on the path, so ``benchmark`` and
``hga_tpu_torch`` import from this checkout."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
