"""The ``hga-torch`` command line against ``hga``: the same flags and
``--config`` JSON give byte-identical outputs (config 3 with the scored SW
refine, config 2 candidates, config 1 spectrum)."""

import json
import os

import numpy as np
import pytest
import torch

from hga_tpu.cli import main as jmain
from hga_tpu_torch.cli import main as tmain
from hga_tpu_torch.io.fastq import write_fasta
from hga_tpu_torch.utils import sim

FLAGS = ["-k", "15", "-w", "5", "--band", "24", "--max-seed-freq", "64",
         "--min-shared", "2", "--min-overlap-len", "40",
         "--min-overlap-score", "40"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_reads")
    genome = sim.random_genome(3000, seed=91)
    shorts, sn = sim.simulate_short_reads(genome, coverage=8, read_len=100,
                                          error_rate=0.004, seed=92)
    longs, ln = sim.simulate_long_reads(genome, coverage=1.5, mean_len=1500,
                                        min_len=1200, error_rate=0.05,
                                        seed=93)
    write_fasta(str(d / "short.fasta"), list(zip(sn, shorts)))
    write_fasta(str(d / "long.fasta"), list(zip(ln, longs)))
    with open(d / "cfg.json", "w") as fh:
        json.dump({"overlap_refine": "sw"}, fh)
    return d


def _both(tmp_path, monkeypatch, cmd, args):
    monkeypatch.setenv("HGA_JAX_CACHE", "0")
    outs = {}
    for tag, main, extra in (("jax", jmain, []),
                             ("torch", tmain, ["--device", "cpu"])):
        out = str(tmp_path / tag)
        assert main([cmd, *args, "-o", out, *extra]) == 0
        outs[tag] = out
    return outs


def test_overlap_sw_paf_matches_hga(reads, tmp_path, monkeypatch, capsys):
    outs = _both(tmp_path, monkeypatch, "overlap",
                 ["--short", str(reads / "short.fasta"),
                  "--long", str(reads / "long.fasta"),
                  "--config", str(reads / "cfg.json"), *FLAGS])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0] == lines[1] and lines[0]["overlaps"] > 10
    a = open(os.path.join(outs["torch"], "overlaps.paf"), "rb").read()
    b = open(os.path.join(outs["jax"], "overlaps.paf"), "rb").read()
    assert a == b
    za = np.load(os.path.join(outs["torch"], "overlaps.npz"))
    zb = np.load(os.path.join(outs["jax"], "overlaps.npz"))
    for f in zb.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)


def test_seeds_and_count_match_hga(reads, tmp_path, monkeypatch):
    for cmd, files in (("seeds", ["candidates.npz"]),
                       ("count", ["spectrum.npz", "spectrum_hist.tsv"])):
        outs = _both(tmp_path / cmd, monkeypatch, cmd,
                     ["--short", str(reads / "short.fasta"), *FLAGS])
        for f in files:
            a = os.path.join(outs["torch"], f)
            b = os.path.join(outs["jax"], f)
            if f.endswith(".tsv"):
                assert open(a, "rb").read() == open(b, "rb").read()
                continue
            za, zb = np.load(a), np.load(b)
            assert za.files == zb.files
            for k in zb.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_cuda_device_without_gpu_raises(reads, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmain(["seeds", "--short", str(reads / "short.fasta"), *FLAGS,
               "-o", str(tmp_path / "x")])


def test_simulate_matches_hga(tmp_path, capsys):
    """`simulate` (FASTA and --fastq): the same files and summary line."""
    for extra in ([], ["--fastq"]):
        lines, outs = [], {}
        for tag, main in (("jax", jmain), ("torch", tmain)):
            out = outs[tag] = str(tmp_path / f"{tag}{len(extra)}")
            assert main(["simulate", "-o", out, "--genome-len", "2000",
                         "--short-cov", "6", "--long-cov", "3", "--seed",
                         "3", *extra]) == 0
            lines.append(capsys.readouterr().out.strip().splitlines()[-1])
        assert lines[0] == lines[1]
        names = sorted(os.listdir(outs["jax"]))
        assert names == sorted(os.listdir(outs["torch"]))
        assert ("short.fastq" in names) == bool(extra)
        for f in names:
            a = open(os.path.join(outs["torch"], f), "rb").read()
            assert a == open(os.path.join(outs["jax"], f), "rb").read(), f


def test_eval_matches_hga(tmp_path, capsys):
    """`eval` with every metric (k-mer, --align, --segs, --exact) on the
    same contigs: the same JSON line."""
    genome = sim.random_genome(3000, seed=91)
    contigs = [("a", genome[200:2600]), ("b", genome[:900] + "ACGTA"),
               ("c", sim.random_genome(400, seed=5))]
    write_fasta(str(tmp_path / "contigs.fasta"), contigs)
    write_fasta(str(tmp_path / "genome.fasta"), [("g", genome)])
    write_fasta(str(tmp_path / "other.fasta"), contigs[:2])
    args = ["eval", "--contigs", str(tmp_path / "contigs.fasta"),
            "--reference", str(tmp_path / "genome.fasta"), "--align",
            "--segs", "--exact", str(tmp_path / "other.fasta"), "-k", "17"]
    outs = []
    for main, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        assert main(args + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert outs[0] == outs[1]
    assert {"identity", "alignment_identity", "segment_identity",
            "exact_match"} <= set(outs[1])


def test_correct_matches_hga(reads, tmp_path, monkeypatch, capsys):
    """`correct` (config 5a alone): corrected.npz and corrected.fasta."""
    outs = _both(tmp_path, monkeypatch, "correct",
                 ["--short", str(reads / "short.fasta"),
                  "--long", str(reads / "long.fasta"), *FLAGS])
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[-2] == lines[-1]
    a = open(os.path.join(outs["torch"], "corrected.fasta"), "rb").read()
    assert a == open(os.path.join(outs["jax"], "corrected.fasta"),
                     "rb").read()
    za = np.load(os.path.join(outs["torch"], "corrected.npz"))
    zb = np.load(os.path.join(outs["jax"], "corrected.npz"))
    assert za.files == zb.files
    for f in zb.files:
        np.testing.assert_array_equal(za[f], zb[f], err_msg=f)
