"""The PyTorch port stands alone: importing every hga_tpu_torch module (and
chip_smoke.py) loads neither jax nor any module of the JAX package."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hga_tpu_torch")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _module_names():
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        yield rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def test_importing_the_port_loads_no_jax():
    mods = sorted(_module_names())
    assert len(mods) >= 16, mods
    for m in ("hga_tpu_torch.cli", "hga_tpu_torch.ops.align",
              "hga_tpu_torch.ops.align_cuda", "hga_tpu_torch.ops.cuda_build",
              "hga_tpu_torch.ops.pairs", "hga_tpu_torch.models.overlap",
              "hga_tpu_torch.models.seeding", "hga_tpu_torch.exp.myers_micro",
              "hga_tpu_torch.exp.sw_variants", "hga_tpu_torch.exp.vpu_micro",
              "hga_tpu_torch.utils.benchmarks",
              "hga_tpu_torch.models.arbitration",
              "hga_tpu_torch.utils.evalx", "hga_tpu_torch.io.native",
              "hga_tpu_torch.models.pipeline",
              "hga_tpu_torch.models.correction",
              "hga_tpu_torch.ops.pileup", "hga_tpu_torch.parallel.mesh",
              "hga_tpu_torch.parallel.hostpart",
              "hga_tpu_torch.parallel.collectives",
              "hga_tpu_torch.parallel.ring_myers",
              "hga_tpu_torch.parallel.launch",
              *(f"hga_tpu_torch.exp.{n}" for n in (
                  "common", "scale_run", "count_scale", "reoverlap",
                  "polish_retry", "asm_sweep", "bench_corr_tb",
                  "diag_repeat_corr", "diag_leak", "diag_polish_votes",
                  "diag_false_ov", "diag_graph"))):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'hga_tpu', "
        "'exp')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'hga_tpu.', "
        "'exp.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_nothing_of_jax():
    files = list(_port_files()) + [os.path.join(ROOT, "chip_smoke.py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "hga_tpu", "exp"), \
                    (path, n)
