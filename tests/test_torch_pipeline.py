"""The port's whole pipeline against the JAX package's on the same simulated
reads and config: every artifact equal (FASTA/GFA byte for byte), resume,
and resume from the JAX package's own output directory — the hybrid path
with copy arbitration off and under the default config (arbitration on,
arbitrated.fasta), and the short-read-only path (candidates + overlaps with
both refine modes, under the default copy-arbitration setting)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models.pipeline import run_pipeline as jrun
from hga_tpu_torch import convert
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models.pipeline import run_pipeline as trun
from hga_tpu_torch.utils import sim

# tests/test_pipeline_cli.CFG, with copy arbitration off; DEFAULT_KW leaves
# it at the default (on)
DEFAULT_KW = dict(k=15, w=5, band=24, max_seed_freq=64,
                  min_shared_minimizers=2, batch_reads=256,
                  min_overlap_len=30, min_overlap_score=40,
                  min_contig_len=300)
KW = dict(DEFAULT_KW, arbitrate=False)
TEXT = ("contigs.fasta", "assembly.gfa", "polished.fasta")
NPZ = ("spectrum.npz", "corrected.npz", "overlaps.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(pack, ds):
    return (pack(ds.short_seqs, names=ds.short_names, pad_len=112),
            pack(ds.long_seqs, names=ds.long_names,
                 category=[1] * len(ds.long_seqs)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ds = sim.make_dataset(genome_len=6000, short_cov=25, long_cov=6,
                          seed=50, short_err=0.002, long_err=0.05)
    root = tmp_path_factory.mktemp("pipe")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jres = jrun(*_reads(jpack, ds), JCfg(**KW), jdir, mesh=None)
    tres = trun(*_reads(tpack, ds), TCfg(**KW), tdir, device="cpu")
    return dict(ds=ds, root=root, jdir=jdir, tdir=tdir, jres=jres, tres=tres)


def test_config_digest_matches_jax():
    for kw in (KW, {}, dict(KW, mesh_shape=(2, 4), min_identity=0.7)):
        assert TCfg(**kw).to_json() == JCfg(**kw).to_json()


def test_every_artifact_matches_jax(runs):
    assert runs["tres"].polished
    assert runs["tres"].polished == runs["jres"].polished
    assert runs["tres"].contigs == runs["jres"].contigs
    for f in TEXT:
        a = open(os.path.join(runs["tdir"], f), "rb").read()
        b = open(os.path.join(runs["jdir"], f), "rb").read()
        assert a == b, f
    for f in NPZ:
        za = np.load(os.path.join(runs["tdir"], f))
        zb = np.load(os.path.join(runs["jdir"], f))
        assert za.files == zb.files, f
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (f, k)
            np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{f}:{k}")
    mj = json.load(open(os.path.join(runs["jdir"], "run_metrics.json")))
    mt = json.load(open(os.path.join(runs["tdir"], "run_metrics.json")))
    # the port's stats add what the run counted (utils/spans)
    assert set(mt) == set(mj) | {"counters"}
    assert mt["counters"]["spectrum.calls"] == 1
    assert set(mt["stages"]) == set(mj["stages"])
    assert mt["config"] == mj["config"]
    for name in ("spectrum", "assembly"):
        assert mt[name] == mj[name]
    assert mt["overlaps"]["n"] == mj["overlaps"]["n"]
    for s in mt["stages"]:
        meta = lambda d: json.load(open(os.path.join(d, f"{s}.meta.json")))
        assert {k: v for k, v in meta(runs["tdir"]).items() if k != "seconds"} \
            == {k: v for k, v in meta(runs["jdir"]).items() if k != "seconds"}


def test_resume_skips_heavy_stages(runs):
    ds = runs["ds"]
    res = trun(*_reads(tpack, ds), TCfg(**KW), runs["tdir"], resume=True,
               device="cpu")
    assert res.polished == runs["tres"].polished
    for s in ("spectrum", "corrected", "overlaps", "assembly"):
        assert s not in res.stats["stages"], s


def test_resume_from_the_jax_output_directory(runs):
    ds = runs["ds"]
    d = str(runs["root"] / "from_jax")
    shutil.copytree(runs["jdir"], d)
    os.remove(os.path.join(d, "polished.fasta"))
    res = trun(*_reads(tpack, ds), TCfg(**KW), d, resume=True, device="cpu")
    for s in ("spectrum", "corrected", "overlaps", "assembly"):
        assert s not in res.stats["stages"], s
    assert "polish" in res.stats["stages"]
    a = open(os.path.join(d, "polished.fasta"), "rb").read()
    b = open(os.path.join(runs["jdir"], "polished.fasta"), "rb").read()
    assert a == b


def test_convert_loaders_read_jax_artifacts(runs):
    j = runs["jdir"]
    spec = convert.load_spectrum(os.path.join(j, "spectrum.npz"))
    z = np.load(os.path.join(j, "spectrum.npz"))
    spec2 = convert.load_spectrum({k: z[k] for k in z.files})
    assert spec.threshold == spec2.threshold == int(z["threshold"])
    np.testing.assert_array_equal(spec.hist, spec2.hist)
    pr = convert.load_corrected(os.path.join(j, "corrected.npz"))
    dr = convert.load_packed_reads(os.path.join(j, "corrected.npz"),
                                   device="cpu")
    np.testing.assert_array_equal(dr.host.packed, pr.packed)
    np.testing.assert_array_equal(
        dr.packed.numpy().view(np.uint32), pr.packed)
    assert dr.length.dtype == torch.int32 and dr.host.names == pr.names
    ov = convert.load_overlaps(os.path.join(j, "overlaps.npz"))
    assert ov.n == runs["tres"].stats["overlaps"]["n"]


def test_unported_modes_and_missing_gpu_raise(runs, tmp_path, monkeypatch):
    # corr_engine="sw" runs (tests/test_torch_sw_engine.py holds it
    # against the JAX package): correction and polish go through its dirs
    # DP, never through K2''s wrapper, and the pipeline finishes
    from hga_tpu_torch.models import correction as TCR

    calls = {"dirs": 0, "myers": 0}

    def spy(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(TCR, "banded_sw_batch_dirs",
                        spy("dirs", TCR.banded_sw_batch_dirs))
    monkeypatch.setattr(TCR, "myers_votes_cuda",
                        spy("myers", TCR.myers_votes_cuda))
    s, l = _reads(tpack, runs["ds"])
    d = str(tmp_path / "a")
    res = trun(s, l, TCfg(**dict(KW, corr_engine="sw")), d, device="cpu")
    assert res.polished and calls["dirs"] > 0 and calls["myers"] == 0
    for f in ("spectrum.npz", "corrected.npz", "polished.fasta"):
        assert os.path.exists(os.path.join(d, f)), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            trun(s, l, TCfg(**KW), str(tmp_path / "c"))


@pytest.fixture(scope="module")
def default_runs(runs):
    """The hybrid pipeline under the default config (copy arbitration on)
    on the same reads, both packages."""
    ds, root = runs["ds"], runs["root"]
    jdir, tdir = str(root / "jax_default"), str(root / "torch_default")
    assert JCfg(**DEFAULT_KW).arbitrate and TCfg(**DEFAULT_KW).arbitrate
    jres = jrun(*_reads(jpack, ds), JCfg(**DEFAULT_KW), jdir, mesh=None)
    tres = trun(*_reads(tpack, ds), TCfg(**DEFAULT_KW), tdir, device="cpu")
    return dict(ds=ds, root=root, jdir=jdir, tdir=tdir, jres=jres,
                tres=tres)


def test_default_config_arbitrates_like_jax(default_runs):
    r = default_runs
    assert r["tres"].polished and r["tres"].polished == r["jres"].polished
    assert r["tres"].contigs == r["jres"].contigs
    for f in TEXT + ("arbitrated.fasta",):
        a = open(os.path.join(r["tdir"], f), "rb").read()
        b = open(os.path.join(r["jdir"], f), "rb").read()
        assert a == b, f
    for f in NPZ:
        za = np.load(os.path.join(r["tdir"], f))
        zb = np.load(os.path.join(r["jdir"], f))
        for k in zb.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{f}:{k}")
    mj = json.load(open(os.path.join(r["jdir"], "run_metrics.json")))
    mt = json.load(open(os.path.join(r["tdir"], "run_metrics.json")))
    assert set(mt) == set(mj) | {"counters"}
    assert set(mt["stages"]) == set(mj["stages"])
    assert "arbitrate" in mt["stages"] and mt["config"] == mj["config"]
    for key in ("n_chunks", "rare_cap"):
        assert mt["arbitrate_detail"][key] == mj["arbitrate_detail"][key]
    meta = lambda d: json.load(open(os.path.join(d, "arbitrate.meta.json")))
    assert {k: v for k, v in meta(r["tdir"]).items() if k != "seconds"} \
        == {k: v for k, v in meta(r["jdir"]).items() if k != "seconds"}


def test_default_config_resumes_past_arbitration(default_runs):
    """Resume skips every stage up to polish, arbitrate included, in the
    port's own directory and in a copy of the JAX package's."""
    r = default_runs
    d = str(r["root"] / "from_jax_default")
    shutil.copytree(r["jdir"], d)
    os.remove(os.path.join(d, "polished.fasta"))
    for out in (r["tdir"], d):
        res = trun(*_reads(tpack, r["ds"]), TCfg(**DEFAULT_KW), out,
                   resume=True, device="cpu")
        for s in ("spectrum", "corrected", "overlaps", "assembly",
                  "arbitrate"):
            assert s not in res.stats["stages"], (out, s)
        assert res.contigs == r["jres"].contigs
        assert res.polished == r["jres"].polished
    a = open(os.path.join(d, "polished.fasta"), "rb").read()
    b = open(os.path.join(r["jdir"], "polished.fasta"), "rb").read()
    assert a == b


# the short-read-only route under the default config (arbitrate=True: the
# reference arbitrates only with long reads)
SR_KW = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
             batch_reads=256, min_overlap_len=30, min_overlap_score=40,
             min_contig_len=300)
SR_TEXT = ("contigs.fasta", "assembly.gfa", "polished.fasta")
SR_NPZ = ("spectrum.npz", "candidates.npz", "overlaps.npz")


@pytest.fixture(scope="module", params=["sw", "myers"])
def short_runs(request, tmp_path_factory):
    ds = sim.make_dataset(genome_len=3000, short_cov=25, long_cov=0,
                          seed=52, short_err=0.002)
    kw = dict(SR_KW, overlap_refine=request.param)
    assert JCfg(**kw).arbitrate and TCfg(**kw).arbitrate
    root = tmp_path_factory.mktemp("short_" + request.param)
    jdir, tdir = str(root / "jax"), str(root / "torch")
    reads = lambda pack: pack(ds.short_seqs, names=ds.short_names,
                              pad_len=112)
    jres = jrun(reads(jpack), None, JCfg(**kw), jdir, mesh=None)
    tres = trun(reads(tpack), None, TCfg(**kw), tdir, device="cpu")
    return dict(reads=reads, kw=kw, root=root, jdir=jdir, tdir=tdir,
                jres=jres, tres=tres)


def test_short_read_only_artifacts_match_jax(short_runs):
    r = short_runs
    assert r["tres"].polished and r["tres"].polished == r["jres"].polished
    assert r["tres"].contigs == r["jres"].contigs
    for f in SR_TEXT:
        a = open(os.path.join(r["tdir"], f), "rb").read()
        b = open(os.path.join(r["jdir"], f), "rb").read()
        assert a == b, f
    for f in SR_NPZ:
        za = np.load(os.path.join(r["tdir"], f))
        zb = np.load(os.path.join(r["jdir"], f))
        assert za.files == zb.files, f
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (f, k)
            np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{f}:{k}")
    assert not os.path.exists(os.path.join(r["tdir"], "corrected.npz"))
    mj = json.load(open(os.path.join(r["jdir"], "run_metrics.json")))
    mt = json.load(open(os.path.join(r["tdir"], "run_metrics.json")))
    assert set(mt) == set(mj) | {"counters"}
    assert set(mt["stages"]) == set(mj["stages"])
    for name in ("spectrum", "candidates", "assembly", "config"):
        assert mt[name] == mj[name], name
    for key in ("n", "gate_pairs", "refine_pairs"):
        assert mt["overlaps"][key] == mj["overlaps"][key], key


def test_short_read_only_resumes_from_the_jax_directory(short_runs):
    r = short_runs
    d = str(r["root"] / "from_jax")
    shutil.copytree(r["jdir"], d)
    os.remove(os.path.join(d, "polished.fasta"))
    res = trun(r["reads"](tpack), None, TCfg(**r["kw"]), d, resume=True,
               device="cpu")
    for s in ("spectrum", "candidates", "overlaps", "assembly"):
        assert s not in res.stats["stages"], s
    assert res.stats["candidates"]["n"] == \
        r["jres"].stats["candidates"]["n"]
    a = open(os.path.join(d, "polished.fasta"), "rb").read()
    b = open(os.path.join(r["jdir"], "polished.fasta"), "rb").read()
    assert a == b
