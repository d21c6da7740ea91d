"""The port's Myers engine (plain PyTorch, the CPU path of K1/K2) against
the JAX package's XLA engine and its Pallas kernels in interpret mode,
bit-exact, on the cases of tests/test_myers_pallas.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import myers as JM
from hga_tpu.ops.myers_pallas import (myers_batch_pallas,
                                      myers_batch_planes_pallas)
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import oracle


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _multiword(seed=0, N=128, Lq=100, Lt=160):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):           # plant real overlaps in half the rows
        off = int(rng.integers(0, Lt - Lq))
        t[n, off:off + Lq] = q[n]
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, Lq))
            t[n, off + p] = (t[n, off + p] + 1) % 4
    ql = rng.integers(1, Lq + 1, N).astype(np.int32)
    ql[:4] = [Lq, Lq - 1, 31, 62]      # word-boundary lengths
    ql[5] = 0
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    return q, t, ql, tl


def _sentinels(seed=1, N=128, Lq=40, Lt=64):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    t[:, :6] = 4                        # window sentinels
    t[3, 10:20] = 9                     # codes >= 8 never match
    t[4, 12:18] = -1                    # negative pads never match
    q[7, 5:9] = 4                       # query sentinels too
    return q, t, np.full(N, Lq, np.int32), np.full(N, Lt, np.int32)


def _two_tiles(seed=2, N=512, Lq=62, Lt=96):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    ql = rng.integers(1, Lq + 1, N).astype(np.int32)
    return q, t, ql, np.full(N, Lt, np.int32)


CASES = {"multiword": _multiword, "sentinels": _sentinels,
         "two_tiles": _two_tiles}


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_myers_batch_matches_jax(case):
    q, t, ql, tl = CASES[case]()
    got = TM.myers_batch(*_t(q, t, ql, tl))
    ref = JM.myers_batch(*_j(q, t, ql, tl))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.tend.numpy(), np.asarray(ref.tend))
    # the K1 wrapper on CPU tensors is the plain version
    w = TMC.myers_batch_cuda(*_t(q, t, ql, tl))
    np.testing.assert_array_equal(w.dist.numpy(), got.dist.numpy())
    np.testing.assert_array_equal(w.tend.numpy(), got.tend.numpy())


@pytest.mark.parametrize("case", ["multiword", "sentinels"])
def test_myers_batch_matches_pallas_interpret(case):
    q, t, ql, tl = CASES[case]()
    got = TM.myers_batch(*_t(q, t, ql, tl))
    ref = myers_batch_pallas(*_j(q, t, ql, tl), pair_sub=1, interpret=True)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.tend.numpy(), np.asarray(ref.tend))


def test_query_planes_match_jax():
    q, _, ql, _ = _multiword()
    q[9, 3:7] = 4
    for W in (4, 5):
        got = TM.query_planes(*_t(q, ql), W)
        ref = JM.query_planes(*_j(q, ql), W)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_oracle_spot_checks():
    q, t, ql, tl = _multiword()
    got = TM.myers_batch(*_t(q, t, ql, tl))
    for n in (0, 1, 2, 3, 5, 17):
        d, e = oracle.edit_distance_hw(q[n, :ql[n]], t[n, :tl[n]])
        assert int(got.dist[n]) == d, n
        assert int(got.tend[n]) == e, n


@pytest.mark.parametrize("case", ["planes", "sentinels"])
def test_myers_batch_planes_matches_jax(case):
    if case == "planes":
        rng = np.random.default_rng(7)
        N, Lq, Lt = 128, 90, 150       # W = 3 words
        q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
        t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
        for n in range(0, N, 2):
            off = int(rng.integers(0, Lt - Lq))
            t[n, off:off + Lq] = q[n]
        t[1, 40:] = 4
        ql = rng.integers(1, Lq + 1, N).astype(np.int32)
        ql[0] = 0
        tl = np.full(N, Lt, np.int32)
    else:
        q, t, ql, tl = _sentinels()
    got, gpv, gmv = TM.myers_batch_planes(*_t(q, t, ql, tl))
    ref, rpv, rmv = JM.myers_batch_planes(*_j(q, t, ql, tl))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.tend.numpy(), np.asarray(ref.tend))
    np.testing.assert_array_equal(gpv.numpy(), np.asarray(rpv))
    np.testing.assert_array_equal(gmv.numpy(), np.asarray(rmv))
    if case == "planes":
        pal, ppv, pmv = myers_batch_planes_pallas(
            *_j(q, t, ql, tl), pair_sub=1, interpret=True)
        np.testing.assert_array_equal(gpv.numpy(), np.asarray(ppv))
        np.testing.assert_array_equal(gmv.numpy(), np.asarray(pmv))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(pal.dist))


def test_wrappers_reject_bad_operands():
    q, t, ql, tl = _t(*_two_tiles())
    with pytest.raises(ValueError):
        TMC.myers_batch_cuda(q.long(), t, ql, tl)
    with pytest.raises(ValueError):
        TMC.myers_batch_planes_cuda(q, t[:10], ql, tl)
    with pytest.raises(ValueError):
        TMC.myers_batch_cuda(q[:, ::2], t, ql, tl)
    # K2s and K1' take every W (K2s at W 25 on 32 lanes, W 35 on both wide
    # routes); only the forced one-thread K2 refuses past 24 words
    w35, w25 = (torch.zeros((4, W * 31), dtype=torch.int32)
                for W in (35, 25))
    r = TMC.kernel_operands(w35, w35, ql[:4], tl[:4])[4]
    assert (r.W, r.G, r.wl, r.S) == (35, 32, 2, 1)
    assert TMC.planes_operands(w25, w25, ql[:4], tl[:4])[0][:3] == \
        (25, 32, 0)
    assert TMC.planes_operands(w35, w35, ql[:4], tl[:4])[0][:3] == \
        (35, 32, 2)
    with pytest.raises(ValueError, match="at most 24 query words"):
        TMC.planes_operands(w25, w25, ql[:4], tl[:4], thread=True)
    with pytest.raises(ValueError, match="lanes"):       # G 1 stops at W 24
        TMC.kernel_operands(w25, w25, ql[:4], tl[:4], group=1)
    with pytest.raises(ValueError, match="lanes"):       # the wide route: 32
        TMC.kernel_operands(w35, w35, ql[:4], tl[:4], group=16)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda):
    for case in sorted(CASES):
        q, t, ql, tl = (x.to(cuda) for x in _t(*CASES[case]()))
        ref = TM.myers_batch(q, t, ql, tl)
        got = TMC.myers_batch_cuda(q, t, ql, tl)
        assert torch.equal(got.dist, ref.dist) and torch.equal(got.tend,
                                                               ref.tend)
        rp, rpv, rmv = TM.myers_batch_planes(q, t, ql, tl)
        gp, gpv, gmv = TMC.myers_batch_planes_cuda(q, t, ql, tl)
        assert torch.equal(gp.dist, rp.dist) and torch.equal(gpv, rpv)
        assert torch.equal(gmv, rmv)


def test_word_caps_by_kernel():
    """K1', K2' and K2s take every W (the register route up to 34, the wide
    route past it: one pair a warp, ceil(W / 32) words a lane); the forced
    one-thread K2 takes 1-24: each operand function accepts every W on its
    route by shape alone, K2 refuses past its own; no plain route is
    counted."""
    assert TMC.REGISTER_MAX_WORDS == 34 and TMC.THREAD_MAX_WORDS == 24
    assert not hasattr(TMC, "PLANES_MAX_WORDS")
    one = torch.ones(1, dtype=torch.int32)
    merged = torch.zeros(2, dtype=torch.int32)
    for W in range(1, 40):
        q = torch.zeros((1, 31 * W), dtype=torch.int32)
        assert TMC._check(q, q, one, one) == (1, W, 31 * W)   # every W
        wide = W > TMC.REGISTER_MAX_WORDS
        for name, build, cap in (
                ("K1'", lambda: TMC.kernel_operands(q, q, one, one)[4],
                 None),
                ("K1' carried state", lambda: TMC.carry_operands(
                    q, q, one, one, TM.myers_init_state(one, W))[4], None),
                ("K2s", lambda: TMC.planes_operands(q, q, one, one)[0],
                 None),
                ("K2", lambda: TMC.planes_operands(q, q, one, one,
                                                   thread=True),
                 TMC.THREAD_MAX_WORDS),
                ("K2'", lambda: TMC.votes_operands(
                    merged, q, q, one, one, one, one, one, min_identity=0.75,
                    size_v=0, lpad=0)[0], None)):
            if cap is None:
                r = build()
                assert r.wl == (-(-W // 32) if wide else 0), (name, W)
            elif W <= cap:
                build()
            else:
                with pytest.raises(ValueError, match="query words"):
                    build()
    assert sorted(TMC.LAUNCHES) == sorted([
        "myers_batch_cuda", "myers_batch_cuda_wide",
        "myers_batch_cuda_shared", "myers_batch_cuda_carry",
        "myers_votes_cuda", "myers_votes_cuda_scratch",
        "myers_votes_cuda_wide", "myers_batch_planes_cuda",
        "myers_batch_planes_cuda_wide"])
    # W 17-34 run on a warp's 32 lanes a pair: one word a lane up to W 32,
    # two at W 33-34; W 25-34 in the split design alone, the wide route
    # past 34 (32 lanes, its counter apart)
    assert all(TMC.GATE_GROUP[W] == 32 for W in range(17, 35))
    assert TMC.group_width(33) == TMC.group_width(34) == 32
    assert all(TMC.gate_designs(W) == (32,) for W in range(25, 60))
    assert TMC.gate_designs(24) == (1, 32)
    r = TMC.gate_route(4096, 1085, 1157)
    assert TMC.gate_counter(r, False) == "myers_batch_cuda_wide"
    assert TMC.gate_counter(r, True) == "myers_batch_cuda_shared"
    assert TMC.gate_counter(TMC.gate_route(4096, 1054, 1126), False) == \
        "myers_batch_cuda"


@pytest.mark.parametrize("Lq", [800, 992, 1024])   # W 26, 32, 34
def test_wide_queries_match_jax(Lq):
    """On CPU tensors K1''s, its carried-state mode's and K2's wrappers give
    the JAX engine's results at W 26, 32 and 34 (short reads padded to
    800-1024)."""
    rng = np.random.default_rng(Lq)
    N, Lt = 6, Lq + 72
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    t[::2, 30:30 + Lq - 40] = q[::2, :Lq - 40]
    ql = np.array([Lq, Lq - 1, 744, 745, 0, 1], np.int32)
    tl = np.array([Lt, Lt, Lt - 5, Lt, Lt, 7], np.int32)
    ref = JM.myers_batch(*_j(q, t, ql, tl))
    n = dict(TMC.LAUNCHES)
    got = TMC.myers_batch_cuda(*_t(q, t, ql, tl))
    st, carry = TMC.myers_cols_cuda(*_t(q, t, ql, tl), TM.myers_init_state(
        torch.from_numpy(ql), TM.n_words(Lq)))
    planes, _, _ = TMC.myers_batch_planes_cuda(*_t(q, t, ql, tl))
    assert TMC.LAUNCHES == n                 # CPU tensors: no counter moves
    for res in (got, carry, planes):
        np.testing.assert_array_equal(res.dist.numpy(), np.asarray(ref.dist))
        np.testing.assert_array_equal(res.tend.numpy(), np.asarray(ref.tend))
    assert int(np.asarray(ref.dist)[0]) < Lq // 4     # a planted overlap
