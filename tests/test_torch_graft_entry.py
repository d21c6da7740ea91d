"""The port's dry-run entry points (hga_tpu_torch.graft_entry) against the
repo root's __graft_entry__.py: entry()'s compute step on its inputs, and
dryrun_multichip(2) on 2 gloo CPU rank processes against the JAX pieces on
a 2-device mesh of the test mesh, on the same draws from default_rng(0)."""

import functools
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hga_tpu_torch import graft_entry as TG


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as JG

    jfn, jargs = JG.entry()
    ref = jax.jit(jfn)(*jargs)
    fn, args = TG.entry(device="cpu")
    assert fn.keywords == {"band": 32} and len(args) == 4
    for a, b in zip(args, jargs):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    for f in ("score", "qend", "tend"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(got.score.max()) > 0


def jax_dryrun(n: int):
    """The reference's dry-run steps (__graft_entry__.dryrun_multichip) on
    an n-device mesh, their values returned instead of asserted."""
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.models.pipeline import run_pipeline
    from hga_tpu.ops import count as C
    from hga_tpu.ops.align import banded_sw_batch
    from hga_tpu.ops.myers import myers_batch
    from hga_tpu.parallel import collectives as PC
    from hga_tpu.parallel.compat import shard_map
    from hga_tpu.parallel.mesh import make_mesh
    from hga_tpu.parallel.ring_myers import myers_ring
    from hga_tpu.utils import sim

    mesh = make_mesh(devices=jax.devices()[:n])
    dp = NamedSharding(mesh, P("data"))
    put = lambda x: jax.device_put(jnp.asarray(x), dp)
    k = 21
    rng = np.random.default_rng(0)
    R, W = 4 * n, 4
    packed = put(rng.integers(0, 2**32, (R, W), dtype=np.uint64)
                 .astype(np.uint32))
    bad = put(np.zeros((R, 2), np.uint32))
    length = put(np.full((R,), 64, np.int32))
    M = 128 * n
    hi = put(rng.integers(0, 1 << 10, M).astype(np.uint32))
    lo = put(rng.integers(0, 2**32, M, dtype=np.uint64).astype(np.uint32))
    NP, Lq, Lt = 8 * n, 64, 96
    q = put(rng.integers(0, 4, (NP, Lq)).astype(np.int32))
    t = put(rng.integers(0, 4, (NP, Lt)).astype(np.int32))
    ql = put(np.full((NP,), Lq, np.int32))
    tl = put(np.full((NP,), Lt, np.int32))
    sw_sharded = shard_map(functools.partial(banded_sw_batch, band=16),
                           mesh=mesh, in_specs=(P("data"),) * 4,
                           out_specs=P("data"), check_rep=False)

    @jax.jit
    def step(packed, bad, length, hi, lo, q, t, ql, tl):
        ck = PC.count_kmers_sharded(mesh, packed, bad, length, k,
                                    shard_cap=512)
        hist = C.spectrum_histogram(ck, 16)
        _, _, overflow = PC.route_by_bucket(mesh, hi, lo, bucket_cap=64)
        hist_b, of_b = PC.spectrum_hist_bucketed(mesh, packed, bad, length,
                                                 k, bucket_cap=512,
                                                 max_count=16)
        return hist, overflow, hist_b, of_b, sw_sharded(q, t, ql, tl)

    hist, overflow, hist_b, of_b, sw = step(packed, bad, length, hi, lo, q,
                                            t, ql, tl)
    NQ, LQ, LT = 2 * n, 33, 64 * n
    qs = jnp.asarray(rng.integers(0, 4, (NQ, LQ)).astype(np.int32))
    ts = jnp.asarray(rng.integers(0, 4, (NQ, LT)).astype(np.int32))
    qls = jnp.full((NQ,), LQ, jnp.int32)
    tls = jnp.full((NQ,), LT, jnp.int32)
    ring = myers_ring(mesh, qs, ts, qls, tls)
    one = myers_batch(qs, ts, qls, tls)
    ds = sim.make_dataset(genome_len=2000, short_cov=20, long_cov=10, seed=2,
                          short_err=0.005, long_err=0.08)
    pr_s = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=128)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    pr_l = pack_reads(ds.long_seqs, names=ds.long_names,
                      category=[1] * len(ds.long_seqs), pad_len=pad)
    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=256,
                          min_shared_minimizers=2, min_overlap_len=30)
    with tempfile.TemporaryDirectory() as td:
        res = run_pipeline(pr_s, pr_l, cfg, td, mesh=mesh)
    a = lambda x: np.asarray(x).tolist()
    return dict(hist=a(hist), overflow=int(overflow), hist_bucketed=a(hist_b),
                overflow_bucketed=int(of_b), sw_score=a(sw.score),
                sw_qend=a(sw.qend), sw_tend=a(sw.tend),
                ring_dist=a(ring.dist), ring_tend=a(ring.tend),
                one_dist=a(one.dist), one_tend=a(one.tend),
                polished=[list(c) for c in res.polished])


def test_dryrun_on_two_ranks_matches_jax():
    outs = TG.dryrun_multichip(2, device="cpu")
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["backend"] == "gloo" and o["world"] == 2
        assert not o["jax_loaded"] and not o["hga_tpu_loaded"]
    ref = jax_dryrun(2)
    assert ref["ring_dist"] == ref["one_dist"]
    assert sum(ref["hist"]) > 0 and ref["polished"]
    # the reference's own draws overflow the route's lanes at 2 devices
    assert ref["overflow"] == 9 and ref["overflow_bucketed"] == 0
    for o in outs:
        for key in ("hist", "overflow", "hist_bucketed", "overflow_bucketed",
                    "sw_score", "sw_qend", "sw_tend", "ring_dist",
                    "ring_tend", "polished"):
            assert o[key] == ref[key], key
