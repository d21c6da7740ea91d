"""K1' and K2' past 34 query words (their wide route, csrc/myers_gate.cu and
csrc/myers_votes.cu) on the CPU: the wrappers' plain versions against the
JAX package's XLA engine at W 35-100, and the user paths that reach the
wide route on the card — compute_overlaps on long reads alone (``hga-torch
overlap --long``) and a correct_long_reads batch with short reads padded
past 1,054 bases — held against the JAX package, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.config import AssemblerConfig as JCfg
from hga_tpu.io.encode import pack_reads as jpack
from hga_tpu.models import correction as JCR
from hga_tpu.models import overlap as JO
from hga_tpu.models import seeding as JS
from hga_tpu.ops import myers as JM
from hga_tpu_torch.config import AssemblerConfig as TCfg
from hga_tpu_torch.io.encode import pack_reads as tpack
from hga_tpu_torch.models import correction as TCR
from hga_tpu_torch.models import overlap as TO
from hga_tpu_torch.models import seeding as TS
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import sim
from hga_tpu_torch.utils import spans


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _wide_inputs(W: int, N: int = 8):
    """N pairs of 31 W query bases against windows of Lq + 72: planted
    overlaps on even rows, qlen 0, 1, 31 W - 1 and 31 W, ragged tlen,
    codes -1, 4 and 9 in queries and targets."""
    rng = np.random.default_rng(W)
    Lq = 31 * W
    Lt = Lq + 72
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        t[n, 40:40 + Lq - 60] = q[n, :Lq - 60]
        t[n, rng.integers(40, Lq, 8)] = rng.integers(0, 4, 8)
    ql = rng.integers(1, Lq + 1, N).astype(np.int32)
    ql[:4] = [Lq, 0, 1, Lq - 1]
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    q[5, 3:9] = [-1, 4, 9, 9, -1, 4]
    t[4, 10:16] = [-1, 4, 9, 9, -1, 4]
    tl = np.full(N, Lt, np.int32)
    tl[N // 2:] = rng.integers(0, Lt + 1, N - N // 2)
    return q, t, ql, tl


def test_plain_versions_past_34_words_match_jax():
    """At W 35, 48, 64, 65 and 100 the K1' wrapper, its carried-state mode
    (over 2 and 3 chunks) and K2's on CPU tensors equal the JAX engine:
    dist, tend, the carried state, the Pv/Mv planes; no counter moves."""
    n = spans.launches()
    for W in (35, 48, 64, 65, 100):
        q, t, ql, tl = _wide_inputs(W)
        ref = JM.myers_batch(*_j(q, t, ql, tl))
        got = TMC.myers_batch_cuda(*_t(q, t, ql, tl))
        for f in ("dist", "tend"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert int(np.asarray(ref.dist)[0]) < 31 * W // 4   # planted
        # the carried state over chunks against JAX's one-shot myers_cols
        jst = JM.myers_cols(*JM.query_planes(*_j(q, ql), W),
                            jnp.asarray(t), jnp.asarray(tl),
                            JM.myers_init_state(jnp.asarray(ql), W))
        Lt = t.shape[1]
        for cuts in ((Lt // 3, Lt), (7, Lt // 2, Lt)):
            st, j0 = TM.myers_init_state(torch.from_numpy(ql), W), 0
            for c in cuts:
                st, res = TMC.myers_cols_cuda(*_t(q, t[:, j0:c], ql, tl), st,
                                              j0)
                j0 = c
            for a, b in zip(st, jst):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(res.dist.numpy(),
                                          np.asarray(ref.dist))
        if W in (35, 65):
            planes = TMC.myers_batch_planes_cuda(*_t(q, t, ql, tl))
            jp = JM.myers_batch_planes(*_j(q, t, ql, tl))
            for a, b in zip(planes[1:], jp[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert spans.launches() == n             # CPU tensors: no counter moves


def test_compute_overlaps_on_long_reads_matches_jax():
    """`hga-torch overlap --long` on long reads alone: compute_overlaps at
    the long reads' pad (the longest read rounded up to 16, as load_reads
    packs it), with the judged seeding (k 15, w 5), on an 8 kb genome whose
    long reads follow make_dataset's rule (2 kb mean, 10% error): W 65-200
    on the card's wide route.  Candidates, records and PAF equal the JAX
    package's."""
    genome = sim.random_genome(8000, seed=31)
    seqs, names = sim.simulate_long_reads(
        genome, coverage=8, mean_len=min(8000, max(2000, 8000 // 8)),
        error_rate=0.10, seed=32)
    pad = -(-max(len(s) for s in seqs) // 16) * 16
    assert TM.n_words(pad) > TMC.REGISTER_MAX_WORDS
    kw = dict(k=15, w=5)
    jpr, tpr = (p(seqs, names=names, category=[1] * len(seqs), pad_len=pad)
                for p in (jpack, tpack))
    jc = JS.find_candidates(jpr, JCfg(**kw))
    tc = TS.find_candidates(tpr, TCfg(**kw), device="cpu")
    for f in ("a", "b", "rel", "diag", "shared"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    ref = JO.compute_overlaps(jpr, jc, JCfg(**kw))
    got = TO.compute_overlaps(tpr, tc, TCfg(**kw), device="cpu")
    assert ref.n > 20
    for f in ("a", "b", "rel", "score", "a_start", "a_end", "b_start",
              "b_end", "a_len", "b_len", "dist"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert got.to_paf(names, names) == ref.to_paf(names, names)


def test_correct_long_reads_at_short_pad_1120():
    """One correct_long_reads batch with 1,100-base short reads padded to
    1,120 (W 37: K2' on its wide route on the card): the corrected long
    reads equal the JAX package's."""
    kw = dict(k=15, w=5, band=24, max_seed_freq=64, min_shared_minimizers=2,
              batch_reads=128, min_overlap_score=30, min_pileup_depth=2,
              corr_batch_pairs=512, min_identity=0.75)
    g = sim.random_genome(4000, seed=94)
    ss, sn = sim.simulate_short_reads(g, coverage=8, read_len=1100,
                                      error_rate=0.005, seed=95)
    ls, ln = sim.simulate_long_reads(g, coverage=3, mean_len=2000,
                                     error_rate=0.06, seed=96)
    pad_l = ((max(len(s) for s in ls) + 31) // 32) * 32
    reads = {tag: (pack(ss, names=sn, pad_len=1120),
                   pack(ls, names=ln, category=[1] * len(ls), pad_len=pad_l))
             for tag, pack in (("j", jpack), ("t", tpack))}
    assert TM.n_words(1120) == 37
    ref = JCR.correct_long_reads(*reads["j"], JCfg(**kw))
    got = TCR.correct_long_reads(*reads["t"], TCfg(**kw), device="cpu")
    assert TCR.LAST_TIMINGS["n_batches"] == 1
    assert TCR.LAST_TIMINGS["n_pairs"] > 50
    assert got.names == ref.names and got.pad_len == ref.pad_len
    for f in ("packed", "bad", "length", "category"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert (got.packed != reads["t"][1].packed).any()   # reads corrected


def test_wide_route_geometry():
    """The wide route of K1' past 34 words: 32 lanes a pair, ceil(W / 32)
    words a lane, 4 warps' words (20 B a word) in shared memory up to
    GATE_WIDE_SMEM and in a device scratch past it (or when asked); the
    long-read pad of a 4.6 Mb judged run (~40 kb, W ~1,300) in shared
    memory; K2''s sub-batches keep each launch's scratch in its budget."""
    r = TMC.gate_route(4096, 40_000, 40_072)
    assert (r.W, r.G, r.wl, r.S, r.words) == (1291, 32, 41, 1, 0)
    assert r.smem == 4 * 5 * 41 * 32 * 4 <= TMC.GATE_WIDE_SMEM
    big = TMC.gate_route(256, 31 * 3000, 31 * 3000 + 72)
    assert big.wl == 94 and big.smem == 0
    assert big.words == TMC.gate_blocks(256, 32) * 4 * 5 * 94 * 32
    forced = TMC.gate_route(256, 1085, 1157, words_scratch=True)
    assert forced.smem == 0 and forced.words == 64 * 4 * 5 * 2 * 32
    assert TMC.gate_route(64, 112, 184, wide=True)[:3] == (4, 32, 1)
    # pad 3,100 (W 100): ~2.5 MB of planes a pair, a 4096-pair batch in
    # launches of at most VOTES_SCRATCH_BYTES
    v = TMC.votes_route(3100, 3172)
    per = TMC.votes_launch_pairs(v, 4096)
    assert 4 <= -(-4096 // per) <= 6
    assert per * v.stride * 4 <= TMC.VOTES_SCRATCH_BYTES
    assert TMC.votes_scratch_bytes(v) == v.stride * 4
