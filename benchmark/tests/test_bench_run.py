"""The command: it fails without a card (never falling back to the CPU) and
in a directory without the program; the references load nothing of the
program, and nothing the benchmark loads is JAX or the JAX package; on a
card, each cell runs correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def _cmd(root, cell, seconds="1", seed="2147483711"):
    return [sys.executable, os.path.join(root, "benchmark", "run.py"),
            "--workload", cell, "--seed", seed, "--seconds", seconds,
            "--trace", "0"]


def _no_result(p):
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(_cmd(ROOT, CELLS[0]), cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    _no_result(p)
    assert "is_available() is False" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(_cmd(str(tmp_path), CELLS[0]), cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    _no_result(p)
    assert "program does not import" in p.stderr


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_references_load_nothing_of_the_program_or_jax():
    top = _loaded("import benchmark.reference.spectrum, "
                  "benchmark.reference.segdist, benchmark.gen, "
                  "benchmark.roofline")
    assert not top & {"jax", "jaxlib", "flax", "hga_tpu", "hga_tpu_torch"}


def test_a_run_loads_no_jax():
    """A whole run of each cell at a small size (on the CPU, past the look
    for a card) loads the port and neither JAX nor the JAX package: whole
    top-level names compared."""
    code = (
        "import copy, os, time\n"
        "from benchmark import harness\n"
        "b = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))\n"
        "def small(c):\n"
        "    c = copy.deepcopy(c); c['genome']['length'] = 3000\n"
        "    c['batch_reads'] = 1024\n"
        "    if 'repeats' in c['genome']:\n"
        "        c['genome']['repeats'].update(rrna_len=300, is_len=150,"
        " tandem_unit=40)\n"
        "    return c\n"
        "for w in b['workloads']:\n"
        "    out, _ = harness.run_cell(b, w['name'], 5, 0.0, True, 'cpu',"
        " time.perf_counter(), small)\n"
        "    assert out['correct'], out\n"
        "    for m in harness.Cell(b, w['name']).metrics(True):\n"
        "        harness.load_module('metrics', m['name'])\n"
        "assert not harness.forbidden_modules()\n")
    top = _loaded(code)
    assert "hga_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "hga_tpu"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(_cmd(ROOT, cell, seconds="5"), cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
