"""Mirrors of tests/test_pipeline_cli.py for the port: ``hga-torch`` (on the
CPU) and ``hga`` on the same files give the same polished.fasta and the
same JSON keys (pipeline + eval, simulate --fastq -> pipeline
--use-quality, correct --corr-engine sw), load_reads gives the reference's
reads on both routes, ``--profile DIR`` writes a Chrome trace, and
``count`` writes spectrum.png."""

import json
import os

import numpy as np
import pytest
import torch

from hga_tpu.cli import main as jmain
from hga_tpu.models.pipeline import load_reads as jload
from hga_tpu_torch.cli import main as tmain
from hga_tpu_torch.io.fastq import write_fasta
from hga_tpu_torch.models import pipeline as TP
from hga_tpu_torch.utils import sim

FLAGS = ["-k", "15", "-w", "5", "--band", "24"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    monkeypatch.setenv("HGA_JAX_CACHE", "0")


def _both(capsys, tmp_path, argv, name):
    """Run `hga argv` and `hga-torch argv --device cpu`, each writing to
    its own outdir; returns {tag: (outdir, last JSON line)}."""
    out = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("torch", tmain, ["--device", "cpu"])):
        d = str(tmp_path / f"{name}_{tag}")
        assert main([*argv, "-o", d, *extra]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        out[tag] = (d, json.loads(line))
    return out


def _same_file(out, f):
    a = open(os.path.join(out["torch"][0], f), "rb").read()
    b = open(os.path.join(out["jax"][0], f), "rb").read()
    assert a == b, f
    return a


def test_cli_pipeline_and_eval(tmp_path, capsys):
    ds = sim.make_dataset(genome_len=2500, short_cov=20, long_cov=0,
                          seed=52, short_err=0.0)
    write_fasta(str(tmp_path / "short.fasta"),
                list(zip(ds.short_names, ds.short_seqs)))
    write_fasta(str(tmp_path / "genome.fasta"), [("g", ds.genome)])
    out = _both(capsys, tmp_path,
                ["pipeline", "--short", str(tmp_path / "short.fasta"),
                 *FLAGS], "asm")
    assert _same_file(out, "polished.fasta")
    assert set(out["torch"][1]) == set(out["jax"][1])
    evals = []
    for main, extra, tag in ((jmain, [], "jax"),
                             (tmain, ["--device", "cpu"], "torch")):
        assert main(["eval", "--contigs",
                     os.path.join(out[tag][0], "polished.fasta"),
                     "--reference", str(tmp_path / "genome.fasta"),
                     *extra]) == 0
        evals.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    assert evals[0] == evals[1]
    assert evals[1]["identity"] > 0.97


@pytest.fixture(scope="module")
def hybrid_files(tmp_path_factory):
    ds = sim.make_dataset(genome_len=6000, short_cov=25, long_cov=6,
                          seed=50, short_err=0.002, long_err=0.05)
    d = tmp_path_factory.mktemp("hybrid")
    write_fasta(str(d / "s.fasta"), list(zip(ds.short_names, ds.short_seqs)))
    write_fasta(str(d / "l.fasta"), list(zip(ds.long_names, ds.long_seqs)))
    return ds, d


@pytest.mark.parametrize("pads", [None, (112, 9008)])
def test_load_reads_roundtrip(hybrid_files, pads):
    """Both routes: no pads (the Python reader) and pads given (the native
    reader), each against the JAX package's load_reads."""
    ds, d = hybrid_files
    kw = {} if pads is None else dict(short_pad=pads[0], long_pad=pads[1])
    paths = ([str(d / "s.fasta")], [str(d / "l.fasta")])
    pr_s, pr_l = TP.load_reads(*paths, **kw)
    assert TP.LAST_LOAD["route"] == ("python" if pads is None else "native")
    assert pr_s.n_reads == len(ds.short_seqs)
    assert pr_l.n_reads == len(ds.long_seqs)
    assert (pr_l.category == 1).all()
    for a, b in zip((pr_s, pr_l), jload(*paths, **kw)):
        for f in ("packed", "bad", "length", "category"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert a.names == b.names and a.pad_len == b.pad_len


def test_cli_simulate_fastq_quality_pipeline(tmp_path, capsys):
    """simulate --fastq -> pipeline --use-quality: the quality plane loads
    and weighted consensus runs the same in both packages."""
    simdir = str(tmp_path / "sim")
    assert tmain(["simulate", "-o", simdir, "--genome-len", "6000",
                  "--short-cov", "25", "--long-cov", "6", "--short-err",
                  "0.005", "--long-err", "0.05", "--seed", "50",
                  "--fastq"]) == 0
    pr_s, _ = TP.load_reads([os.path.join(simdir, "short.fastq")],
                            keep_quality=True)
    assert pr_s.qual is not None and int(pr_s.qual.max()) >= 30
    out = _both(capsys, tmp_path,
                ["pipeline", *FLAGS, "--min-shared", "2",
                 "--min-overlap-len", "30", "--use-quality",
                 "--short", os.path.join(simdir, "short.fastq"),
                 "--long", os.path.join(simdir, "long.fasta")], "runq")
    assert _same_file(out, "polished.fasta")
    assert set(out["torch"][1]) == set(out["jax"][1])


def test_cli_correct_sw_engine(hybrid_files, tmp_path, capsys):
    _, d = hybrid_files
    out = _both(capsys, tmp_path,
                ["correct", "--short", str(d / "s.fasta"), "--long",
                 str(d / "l.fasta"), *FLAGS, "--corr-engine", "sw"], "corr")
    assert _same_file(out, "corrected.fasta")
    assert out["torch"][1] == out["jax"][1]


@pytest.mark.parametrize("cmd", ["count", "simulate"])
def test_profile_writes_a_trace(tmp_path, cmd):
    prof = tmp_path / "prof"
    if cmd == "simulate":
        argv = ["simulate", "-o", str(tmp_path / "sim"), "--genome-len",
                "2000", "--short-cov", "4", "--long-cov", "0"]
    else:
        genome = sim.random_genome(2000, seed=4)
        seqs, names = sim.simulate_short_reads(genome, coverage=8,
                                               read_len=100, seed=5)
        write_fasta(str(tmp_path / "s.fasta"), list(zip(names, seqs)))
        argv = ["count", "--short", str(tmp_path / "s.fasta"), "-k", "15",
                "-o", str(tmp_path / "cnt"), "--device", "cpu"]
    assert tmain([*argv, "--profile", str(prof)]) == 0
    trace = json.load(open(prof / "trace.json"))
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]


def test_count_writes_spectrum_png(tmp_path):
    pytest.importorskip("matplotlib")
    genome = sim.random_genome(2000, seed=6)
    seqs, names = sim.simulate_short_reads(genome, coverage=10, read_len=100,
                                           seed=7)
    write_fasta(str(tmp_path / "s.fasta"), list(zip(names, seqs)))
    out = tmp_path / "cnt"
    assert tmain(["count", "--short", str(tmp_path / "s.fasta"), "-k", "15",
                  "-o", str(out), "--device", "cpu"]) == 0
    png = open(out / "spectrum.png", "rb").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000
