"""Seeding of the port (minimizers, seed entries, solid mask, sorted seed
index, indexed cross candidates) against the JAX package, exact and in
order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import overlap_long as JOL
from hga_tpu.models import seeding as JS
from hga_tpu.models.spectrum import count_reads as jcount
from hga_tpu.ops import kmer as JK
from hga_tpu.ops import minimizer as JM
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models import overlap_long as TOL
from hga_tpu_torch.models import seeding as TS
from hga_tpu_torch.ops import kmer as TK
from hga_tpu_torch.ops import minimizer as TM
from hga_tpu_torch.utils import sim

KW = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
          batch_reads=256, corr_depth_cap=12, corr_rare_seed_freq=40)


@pytest.fixture(scope="module")
def data():
    ds = sim.make_dataset(genome_len=12000, short_cov=15, long_cov=5,
                          seed=71, short_err=0.01, long_err=0.08)
    pad_l = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    mk = lambda pack: (
        pack(ds.short_seqs, names=ds.short_names, pad_len=112),
        pack(ds.long_seqs, names=ds.long_names,
             category=[1] * len(ds.long_seqs), pad_len=pad_l))
    js, jl = mk(jpack)
    ts, tl = mk(tpack)
    solid = jcount(js, JCfg(**KW)).solid_set()
    return js, jl, ts, tl, solid


@pytest.mark.parametrize("w", [1, 5, 11])
def test_select_minimizers_matches_jax(data, w):
    js = data[0]
    pr = js.subset(np.arange(64))
    length = pr.length.copy()
    length[3] = 10                           # shorter than a window
    kj = JK.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                          jnp.asarray(length), 15)
    ref = JM.select_minimizers(kj, w, jnp.asarray(length), 15)
    kt = TK.extract_kmers(TK.words_to_tensor(pr.packed, "cpu"),
                          TK.words_to_tensor(pr.bad, "cpu"),
                          torch.from_numpy(length), 15)
    got = TM.select_minimizers(kt, w, torch.from_numpy(length), 15)
    take = np.asarray(ref.take)
    np.testing.assert_array_equal(got.take.numpy(), take)
    for f in ("pos", "hi", "lo", "strand"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[take].astype(np.int64),
            np.asarray(getattr(ref, f))[take].astype(np.int64), err_msg=f)


@pytest.mark.parametrize("which", ["short", "long"])
def test_seed_entries_and_solid_mask_match_jax(data, which):
    js, jl, ts, tl, solid = data
    jpr, tpr = (js, ts) if which == "short" else (jl, tl)
    ref = JS.extract_seed_entries(jpr, JCfg(**KW))
    got = TS.extract_seed_entries(tpr, TCfg(**KW), device="cpu")
    for f in ("hi", "lo", "read", "pos", "strand"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        TS.solid_mask(got.hi, got.lo, solid, device="cpu"),
        JS.solid_mask(ref.hi, ref.lo, solid))


def test_seed_index_and_cross_candidates_match_jax(data):
    js, jl, ts, tl, solid = data
    jidx = JOL.build_seed_index(js, JCfg(**KW), solid=solid)
    tidx = TOL.build_seed_index(ts, TCfg(**KW), solid=solid, device="cpu")
    for f in ("srt_key", "srt_read", "srt_pos", "srt_strand", "run_start",
              "run_len", "run_of_slot"):
        np.testing.assert_array_equal(getattr(tidx, f), getattr(jidx, f),
                                      err_msg=f)
    for depth_cap, rare_cap in ((0, 0), (12, 40)):
        ref = JOL.find_candidates_cross_indexed(
            js, jl, JCfg(**KW), index=jidx, depth_cap=depth_cap,
            rare_cap=rare_cap)
        got = TOL.find_candidates_cross_indexed(
            ts, tl, TCfg(**KW), index=tidx, depth_cap=depth_cap,
            rare_cap=rare_cap, device="cpu")
        assert ref[0].size > 100
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
