"""The port's native FASTQ/FASTA reader (io/native.py, its own copy of
fastq_pack.cpp built with g++ into hga_tpu_torch/_build/) against the port's
pure-Python reader and the JAX package's native reader, bit for bit: FASTA
with multi-line records and N/lowercase bases, FASTQ, gzip, reads longer
than pad_len, batch edges; load_reads' native route array-equal to its
Python route; the route rules; builds racing in several processes; and a
library that does not build."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from hga_tpu.io import native as JNV
from hga_tpu.models.pipeline import load_reads as jload
from hga_tpu_torch.io import encode as E
from hga_tpu_torch.io import fastq as FQ
from hga_tpu_torch.io import native as NV
from hga_tpu_torch.models import pipeline as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("packed", "bad", "length", "category")


def _read(mod, path, pad_len, batch):
    packed, bad, lengths, names = [], [], [], []
    for p, b, n_, nm in mod.read_packed_batches(path, pad_len,
                                                batch_reads=batch):
        packed.append(p)
        bad.append(b)
        lengths.append(n_)
        names.extend(nm)
    return (np.concatenate(packed), np.concatenate(bad),
            np.concatenate(lengths), names)


def _assert_matches(path, pad_len, batch=7):
    """The port's native reader == the port's Python reader, and == the
    JAX package's native reader where it is available."""
    assert NV.available(), NV.UNAVAILABLE
    recs = list(FQ.iter_records(path))
    pr = E.pack_reads([r.seq for r in recs], names=[r.name for r in recs],
                      pad_len=pad_len)
    p, b, n_, names = got = _read(NV, path, pad_len, batch)
    for a, want in ((p, pr.packed), (b, pr.bad), (n_, pr.length)):
        assert a.dtype == want.dtype and np.array_equal(a, want)
    assert names == pr.names
    if JNV.available():
        ref = _read(JNV, path, pad_len, batch)
        for a, r in zip(got[:3], ref[:3]):
            assert np.array_equal(a, r)
        assert got[3] == ref[3]
    return got


def _seqs(rng, n, lo, hi, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def test_fasta_multiline_n_and_lowercase(tmp_path):
    seqs = _seqs(np.random.default_rng(1), 25, 1, 300, "ACGTNacgtn")
    path = str(tmp_path / "x.fasta")
    FQ.write_fasta(path, [(f"r{i} extra descr", s)
                          for i, s in enumerate(seqs)], width=60)
    _assert_matches(path, pad_len=304)


def test_fastq(tmp_path):
    seqs = _seqs(np.random.default_rng(2), 33, 10, 200, "ACGTN")
    path = str(tmp_path / "x.fastq")
    FQ.write_fastq(path, [(f"q{i}", s, "I" * len(s))
                          for i, s in enumerate(seqs)])
    _assert_matches(path, pad_len=208)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_gzip(tmp_path, fmt):
    seqs = _seqs(np.random.default_rng(3), 10, 40, 60)
    if fmt == "fasta":
        raw = "".join(f">g{i}\n{s}\n" for i, s in enumerate(seqs))
    else:
        raw = "".join(f"@g{i}\n{s}\n+\n{'I' * len(s)}\n"
                      for i, s in enumerate(seqs))
    path = str(tmp_path / f"x.{fmt}.gz")
    with gzip.open(path, "wt") as fh:
        fh.write(raw)
    _assert_matches(path, pad_len=64)


def test_reads_longer_than_pad_are_truncated(tmp_path):
    path = str(tmp_path / "t.fasta")
    FQ.write_fasta(path, [("long", "ACGT" * 50), ("short", "GGA")])
    p, _, n_, _ = _assert_matches(path, pad_len=64)
    assert n_.tolist() == [64, 3]


@pytest.mark.parametrize("batch", [1, 5, 12, 13])
def test_batch_edges(tmp_path, batch):
    """12 reads in batches of 1, 5 (a ragged last batch), 12 (one full
    batch, then the end of the file) and 13 (one short batch)."""
    seqs = _seqs(np.random.default_rng(4), 12, 20, 90)
    path = str(tmp_path / "e.fastq")
    FQ.write_fastq(path, [(f"e{i}", s, "#" * len(s))
                          for i, s in enumerate(seqs)])
    got = _assert_matches(path, pad_len=96, batch=batch)
    assert len(got[3]) == 12


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """Short reads as FASTQ, long reads as multi-line FASTA and again as
    gzip FASTQ."""
    d = tmp_path_factory.mktemp("native_reads")
    rng = np.random.default_rng(8)
    shorts = _seqs(rng, 300, 90, 101, "ACGTN")
    longs = _seqs(rng, 12, 600, 2500)
    FQ.write_fastq(str(d / "s.fastq"), [(f"sr_{i} x", s, "I" * len(s))
                                        for i, s in enumerate(shorts)])
    FQ.write_fasta(str(d / "l.fasta"), [(f"lr_{i}", s)
                                        for i, s in enumerate(longs)])
    with gzip.open(str(d / "l.fastq.gz"), "wt") as fh:
        for i, s in enumerate(longs):
            fh.write(f"@lr_{i}\n{s}\n+\n{'5' * len(s)}\n")
    return d


def _assert_same_reads(a, b):
    for x, y in zip(a, b):
        for f in FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f
        assert x.names == y.names and x.pad_len == y.pad_len


@pytest.mark.parametrize("long_file", ["l.fasta", "l.fastq.gz"])
def test_load_reads_native_route_equals_python(read_files, long_file):
    s, l_ = [str(read_files / "s.fastq")], [str(read_files / long_file)]
    native = TP.load_reads(s, l_, short_pad=112, long_pad=2512)
    assert TP.LAST_LOAD == {"route": "native"}
    python = TP._load_python(s, l_, 112, 2512, False)
    _assert_same_reads(native, python)
    assert native[0].n_reads == 300 and native[1].n_reads == 12
    assert (native[1].category == 1).all()
    # the JAX package's load_reads (its native route where available)
    _assert_same_reads(native, jload(s, l_, short_pad=112, long_pad=2512))


def test_load_reads_route_rules(read_files):
    s, l_ = [str(read_files / "s.fastq")], [str(read_files / "l.fasta")]
    for kw, why in ((dict(), "pads not given"),
                    (dict(short_pad=112), "pads not given"),
                    (dict(short_pad=112, long_pad=2512, keep_quality=True),
                     "keep_quality")):
        out = TP.load_reads(s, l_, **kw)
        assert TP.LAST_LOAD == {"route": "python", "why": why}, kw
        assert out[0].n_reads == 300 and out[1].n_reads == 12
    # long_pad is needed only when long files are given
    pr_s, pr_l = TP.load_reads(s, short_pad=112)
    assert TP.LAST_LOAD["route"] == "native" and pr_l is None
    assert pr_s.n_reads == 300


def test_concurrent_builds_all_load(tmp_path):
    """Four processes build the library into one empty directory at once:
    each writes its own temporary file and renames it into place, so every
    one loads a whole library."""
    code = ("import sys\n"
            "from hga_tpu_torch.io import native as NV\n"
            f"NV.BUILD_DIR = {str(tmp_path)!r}\n"
            "ok = NV.available()\n"
            "print(ok, NV.lib_path(), NV.UNAVAILABLE)\n"
            "sys.exit(0 if ok else 1)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = {o.split()[1] for o, _ in outs}
    assert len(libs) == 1 and os.path.exists(libs.pop())
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_unbuildable_library_takes_the_python_route(tmp_path, read_files,
                                                    monkeypatch):
    bad = tmp_path / "fastq_pack.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(NV, "SRC", str(bad))
    monkeypatch.setattr(NV, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(NV, "_lib", None)
    monkeypatch.setattr(NV, "UNAVAILABLE", None)
    assert not NV.available()
    assert "no_such_header_here.h" in NV.UNAVAILABLE
    with pytest.raises(RuntimeError, match="unavailable"):
        next(NV.read_packed_batches(str(read_files / "s.fastq"), 112))
    s = [str(read_files / "s.fastq")]
    pr_s, _ = TP.load_reads(s, short_pad=112)
    assert TP.LAST_LOAD["route"] == "python"
    assert TP.LAST_LOAD["why"].startswith("native reader unavailable")
    _assert_same_reads((pr_s,), (TP._load_python(s, (), 112, None,
                                                 False)[0],))
