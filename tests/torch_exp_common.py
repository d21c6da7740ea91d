"""What the tests of the port's exp/ scripts share: each script's main() as
``python -m`` runs it, on both packages, and one torch thread a module.

The JAX side runs with the XLA compile cache off (``HGA_JAX_CACHE=0``) and
on one device (run_pipeline's auto mesh would take the 8-device CPU mesh
of conftest.py).  Its ``count_reads`` runs once per read set and config in
a test process: the scripts count the same reads again (count_scale's warm
pass, the spectrum of each diagnostic), and one JAX count of 6000 reads
takes ~8 s on the CPU.  The count is deterministic, so the scripts print
and write what they would without it."""

import hashlib
import importlib
import runpy
import sys

import numpy as np
import pytest

_JAX_COUNTS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the port's CPU runs here take about as long on
    one as on eight, and parallel test workers share the cores (results do
    not depend on it)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_main(module: str, argv):
    """exp/<module>.py's main() (or its module body, for the scripts that
    run at import) with sys.argv set as ``python -m exp.<module>`` sets
    it; returns the module's globals."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("HGA_JAX_CACHE", "0")
        m.setattr(sys, "argv", [module, *argv])
        import hga_tpu.models.spectrum as jspec
        import hga_tpu.parallel.mesh as jmesh

        m.setattr(jmesh, "auto_mesh", lambda *a, **k: None)
        m.setattr(jspec, "count_reads", _counted_once(jspec.count_reads))
        return runpy.run_module(f"exp.{module}", run_name="__main__")


def _counted_once(count_reads):
    def count(pr, cfg, *args, **kwargs):
        key = (hashlib.sha1(b"".join(
                   np.asarray(x).tobytes() for x in (
                       pr.packed, pr.bad, pr.length, pr.category))
               ).hexdigest(),
               cfg.to_json(), args, tuple(sorted(kwargs.items())))
        if key not in _JAX_COUNTS:
            _JAX_COUNTS[key] = count_reads(pr, cfg, *args, **kwargs)
        return _JAX_COUNTS[key]

    return count


def port_main(module: str, argv):
    mod = importlib.import_module(f"hga_tpu_torch.exp.{module}")
    return mod.main([*argv, "--device", "cpu"])


def untimed(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if not k.endswith("seconds") and k != "seconds"}
