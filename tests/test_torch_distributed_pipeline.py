"""The port's pipeline on a world of 2 and of 4 gloo CPU ranks (one process a
rank, parallel/launch.py) against the JAX package's on a 2- and 4-device
mesh (the 8-device test mesh), on test_distributed_pipeline.py's 3 kb
hybrid data set: every artifact byte for byte (spectrum.npz the full
distinct set, as the mesh path keeps it), the host work split by
block_range (test_multiprocess.py's rule: no rank above 70% + 1), resume
off with a warning and only rank 0 writing; config 3 (compute_overlaps_cross
with the SW refine) on 2 ranks; and `hga-torch bench --what scaling|comm`
on 2 ranks.

No JAX import at the top: the rank processes import this module, and each
asserts that neither jax nor hga_tpu loaded.
"""

import concurrent.futures
import contextlib
import io
import json
import logging
import os

import numpy as np
import pytest

from hga_tpu_torch.parallel.launch import launch

HERE = os.path.dirname(os.path.abspath(__file__))
# tests/test_distributed_pipeline.py's config
KW = dict(k=15, w=5, band=32, batch_reads=512, min_shared_minimizers=2,
          min_overlap_len=30)
TEXT = ("contigs.fasta", "assembly.gfa", "arbitrated.fasta",
        "polished.fasta")
NPZ = ("spectrum.npz", "corrected.npz", "overlaps.npz")


def _dataset(pack):
    from hga_tpu_torch.utils import sim

    ds = sim.make_dataset(genome_len=3000, short_cov=25, long_cov=12, seed=5,
                          short_err=0.005, long_err=0.08)
    pr_s = pack(ds.short_seqs, names=ds.short_names, pad_len=128)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    pr_l = pack(ds.long_seqs, names=ds.long_names,
                category=[1] * len(ds.long_seqs), pad_len=pad)
    return pr_s, pr_l


# ---------------------------------------------------------------- workers

def _w_pipeline(root: str):
    """run_pipeline on the mesh of ranks into root/run<rank>, asked to
    resume (which the world turns off, with a warning)."""
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.pipeline import run_pipeline
    from hga_tpu_torch.parallel import hostpart as HP

    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger("hga_tpu_torch").addHandler(handler)
    res = run_pipeline(*_dataset(pack_reads), AssemblerConfig(**KW),
                       os.path.join(root, f"run{HP.pid()}"), resume=True,
                       device="cpu")
    return dict(polished=res.polished, contigs=res.contigs, work=HP.WORK,
                warned=warned)


def _w_config3(out: str):
    """Config 3 (refine sw) on the mesh of ranks; rank 0 saves the
    records."""
    from hga_tpu_torch.config import AssemblerConfig
    from hga_tpu_torch.io.encode import pack_reads
    from hga_tpu_torch.models.overlap import compute_overlaps_cross
    from hga_tpu_torch.parallel import hostpart as HP

    ov = compute_overlaps_cross(*_dataset(pack_reads), AssemblerConfig(
        **KW, overlap_refine="sw"), device="cpu")
    if HP.is_main():
        ov.save(out)
    return dict(n=ov.n)


def _w_cli(argv):
    """`hga-torch` in the world; what rank 0 printed."""
    from hga_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return dict(stdout=buf.getvalue())


# ---------------------------------------------------------------- tests

def _check_ranks(outs, P):
    for o in outs:
        assert not o["jax_loaded"] and not o["hga_tpu_loaded"], o
        assert o["backend"] == "gloo" and o["world"] == P
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on 2 and 4 ranks (each in the background) while this
    process runs the JAX package on 2- and 4-device meshes."""
    import jax

    from hga_tpu.config import AssemblerConfig as JCfg
    from hga_tpu.io.encode import pack_reads as jpack
    from hga_tpu.models.pipeline import run_pipeline as jrun
    from hga_tpu.parallel.mesh import make_mesh

    root = tmp_path_factory.mktemp("dist")
    pool = concurrent.futures.ThreadPoolExecutor(3)
    port = {P: pool.submit(launch, "test_torch_distributed_pipeline:"
                           "_w_pipeline", P, str(root / f"t{P}"),
                           {"root": str(root / f"t{P}")}, device="cpu",
                           threads=1, pythonpath=[HERE], timeout=900)
            for P in (2, 4)}
    c3 = pool.submit(launch, "test_torch_distributed_pipeline:_w_config3",
                     2, str(root / "c3"),
                     {"out": str(root / "c3" / "overlaps.npz")},
                     device="cpu", threads=1, pythonpath=[HERE], timeout=600)
    jax_dirs = {}
    for P in (2, 4):
        jax_dirs[P] = str(root / f"j{P}")
        jrun(*_dataset(jpack), JCfg(**KW), jax_dirs[P],
             mesh=make_mesh(devices=jax.devices()[:P]))
    return dict(root=root, port=port, c3=c3, jax=jax_dirs)


@pytest.mark.parametrize("P", [2, 4])
def test_pipeline_artifacts_match_jax_mesh(runs, P):
    """Rank 0's artifacts equal the JAX P-device mesh run's, byte for byte
    (FASTA/GFA) and array for array with dtypes (spectrum.npz keeps the
    full distinct set); every rank returns the same contigs."""
    outs = _check_ranks(runs["port"][P].result(), P)
    tdir, jdir = os.path.join(runs["root"], f"t{P}", "run0"), runs["jax"][P]
    for f in TEXT:
        a = open(os.path.join(tdir, f), "rb").read()
        assert a == open(os.path.join(jdir, f), "rb").read(), f
    assert a.count(b">") >= 1
    for f in NPZ:
        za, zb = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir, f))
        assert za.files == zb.files, f
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (f, k)
            np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{f}:{k}")
    spec = np.load(os.path.join(tdir, "spectrum.npz"))
    assert int(spec["distinct"]) == spec["hi"].size
    assert (spec["count"] < spec["threshold"]).any()   # not only the solid
    for o in outs[1:]:
        assert o["polished"] == outs[0]["polished"]
        assert o["contigs"] == outs[0]["contigs"]


@pytest.mark.parametrize("P", [2, 4])
def test_work_split_by_block_range(runs, P):
    """Each partitioned stage's WORK counters sum over the ranks to the
    whole, each rank's share is its block_range block, and no rank did
    more than 70% + 1 (test_multiprocess.py's rule)."""
    outs = runs["port"][P].result()
    n_long = _dataset(lambda *a, **k: len(a[0]))[1]
    for key in ("corr_backbones", "long_query_reads"):
        got = [o["work"].get(key, 0) for o in outs]
        tot = sum(got)
        assert tot == n_long, (key, got)
        assert max(got) <= 0.7 * tot + 1, (key, got)
        base, rem = divmod(tot, P)
        assert got == [base + (r < rem) for r in range(P)], (key, got)


@pytest.mark.parametrize("P", [2, 4])
def test_resume_off_and_rank0_writes(runs, P):
    """resume=True is turned off with a warning on every rank, and only
    rank 0 wrote artifacts or stage metadata."""
    outs = runs["port"][P].result()
    for o in outs:
        assert any("disabling --resume" in w for w in o["warned"]), o
    for r in range(1, P):
        d = os.path.join(runs["root"], f"t{P}", f"run{r}")
        assert os.listdir(d) == [], (r, os.listdir(d))
    d0 = os.listdir(os.path.join(runs["root"], f"t{P}", "run0"))
    assert "run_metrics.json" in d0 and "polish.meta.json" in d0


def test_config3_on_two_ranks(runs):
    """compute_overlaps_cross (refine sw) split over 2 ranks == the JAX
    package's on a 2-device mesh, every record field."""
    import jax

    from hga_tpu.config import AssemblerConfig as JCfg
    from hga_tpu.io.encode import pack_reads as jpack
    from hga_tpu.models.overlap import compute_overlaps_cross as jcross
    from hga_tpu.parallel.mesh import make_mesh

    j = jcross(*_dataset(jpack), JCfg(**KW, overlap_refine="sw"),
               mesh=make_mesh(devices=jax.devices()[:2]))
    outs = _check_ranks(runs["c3"].result(), 2)
    assert outs[0]["n"] == outs[1]["n"] == j.n > 0
    z = np.load(os.path.join(runs["root"], "c3", "overlaps.npz"))
    for k in z.files:
        np.testing.assert_array_equal(z[k], np.asarray(getattr(j, k)),
                                      err_msg=k)


def test_bench_scaling_and_comm_on_two_ranks(tmp_path):
    """`hga-torch bench --what scaling|comm --device cpu` on 2 ranks: rank 0
    prints the JAX package's keys (bench_scaling with a mesh, :320-342;
    comm_volume_model's dict exactly), and says the ranks share the CPU."""
    from hga_tpu.utils.benchmarks import comm_volume_model

    for what in ("scaling", "comm"):
        outs = _check_ranks(launch(
            "test_torch_distributed_pipeline:_w_cli", 2,
            str(tmp_path / what),
            {"argv": ["bench", "--what", what, "--device", "cpu"]},
            device="cpu", threads=1, pythonpath=[HERE], timeout=300), 2)
        assert outs[1]["stdout"] == ""
        got = json.loads(outs[0]["stdout"])
        if what == "comm":
            assert got == json.loads(json.dumps(comm_volume_model()))
            continue
        assert {"devices", "reads", "single_reads_per_s",
                "sharded_reads_per_s", "scaling_efficiency"} <= set(got)
        assert got["devices"] == 2 and got["sharded_reads_per_s"] > 0
        assert "not a scaling figure" in got["note"]
