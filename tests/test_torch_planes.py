"""K2s (csrc/myers.cu ``myers_planes_kernel<W, G>``), the planes DP split
across lanes at any W, on the CPU: its schedule emulated step by step in
plain PyTorch and held exactly against the JAX package's
``myers_batch_planes`` (XLA) at W 1, 4, 24, 25, 34, 35 and 100 (dist,
tend, Pv, Mv); the wrapper on CPU tensors against JAX past W 24; the
planes routes; and, marked ``cuda``, the kernel against its plain version
on the card.

The emulation follows the kernel's order of work: a pair on G =
group_width(W) lanes, lane w holding words w * WL .. w * WL + WL - 1 (WL =
ceil(W / G), A = ceil(W / WL) lanes hold words, a spare word past W on
empty planes); at step s lane w runs target column s - w with the carries
(adder, Ph and Mh shifts) lane w - 1 made at step s - 1, lane 0 taking 0;
the score moves on the lane of the end bit; each lane writes its words of
column s - w into ring slot (s - w) mod A, and after the step the warp
stores column s - A + 1 from its slot as one run of the (Lt, N, W) planes
(the emulation asserts the slot then holds that column, whole)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import myers as JM
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import spans

M31 = (1 << 31) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def planes_schedule(q, t, qlen, tlen):
    """K2s as the kernel runs it, vectorised over pairs and a group's
    lanes; returns (dist, tend, pv planes, mv planes)."""
    N, Lq = q.shape
    Lt = t.shape[1]
    W = TM.n_words(Lq)
    r = TMC.planes_route(Lq)
    WL = r.wl or -(-W // r.G)
    A = -(-W // WL)
    # the lanes' words, A x WL of them: past W on empty planes (codes 4)
    q0, q1, vq, mend = (x.long().view(N, A, WL) for x in
                        TM.query_planes(q, qlen, A * WL))
    mend = mend * (torch.arange(A * WL) < W).long().view(1, A, WL)
    pv = torch.full((N, A, WL), M31, dtype=torch.int64)
    mv = torch.zeros((N, A, WL), dtype=torch.int64)
    tt = t.long()
    ql, tl = qlen.long(), tlen.long()
    score, best, bj = ql.clone(), ql.clone(), torch.zeros(N, dtype=torch.long)
    lane = torch.arange(A)
    out = torch.zeros((N, A, 3), dtype=torch.int64)   # cin, cp, cm out
    ring = torch.zeros((A, 2, N, W), dtype=torch.int64)
    tag = torch.full((A, N, W), -1, dtype=torch.int64)  # column a word holds
    ppv = torch.full((Lt, N, W), -7, dtype=torch.int64)
    pmv = ppv.clone()
    for s in range(Lt + A - 1):
        j = s - lane                                     # each lane's column
        live = (j >= 0) & (j < Lt)
        cin_all = torch.cat([torch.zeros((N, 1, 3), dtype=torch.int64),
                             out[:, :-1]], dim=1)        # from lane w - 1
        tc = tt[:, j.clamp(0, max(Lt - 1, 0))] if Lt else \
            torch.zeros((N, A), dtype=torch.int64)
        t0, t1 = -(tc & 1), -((tc >> 1) & 1)
        tvm = -((tc >= 0) & (tc < 4)).long()
        cin, cp, cm = (cin_all[..., k] for k in range(3))
        pb = torch.zeros((N, A), dtype=torch.int64)
        mb = pb.clone()
        npv, nmv = pv.clone(), mv.clone()
        for k in range(WL):
            p, m = pv[..., k], mv[..., k]
            eq = (vq[..., k] & ~((q0[..., k] ^ t0) | (q1[..., k] ^ t1))) & tvm
            xv = eq | m
            sw = (eq & p) + p + cin
            cin = sw >> 31
            xh = ((sw & M31) ^ p) | eq
            ph = m | (~(xh | p) & 0xFFFFFFFF)
            mh = p & xh
            pb |= ph & mend[..., k]
            mb |= mh & mend[..., k]
            ncp, ncm = (ph >> 30) & 1, (mh >> 30) & 1
            ph = ((ph << 1) & M31) | cp
            mh = ((mh << 1) & M31) | cm
            cp, cm = ncp, ncm
            npv[..., k] = (mh | ~(xv | ph)) & M31
            nmv[..., k] = ph & xv
        pv = torch.where(live[None, :, None], npv, pv)
        mv = torch.where(live[None, :, None], nmv, mv)
        out = torch.where(live[None, :, None],
                          torch.stack([cin, cp, cm], dim=2), out)
        # the end bit's lane moves the score on its own column
        step = ((pb != 0).long() - (mb != 0).long()) * live.long()
        score = score + step.sum(dim=1)
        e = ((ql - 1).clamp(min=0) // 31 // WL).clamp(max=A - 1)
        je = s - e
        ok = (ql > 0) & (je >= 0) & (je < Lt)
        take = ok & (score < best) & (je < tl)
        best = torch.where(take, score, best)
        bj = torch.where(take, je + 1, bj)
        # each lane's words of column j into ring slot j mod A
        for w in range(A):
            if not bool(live[w]):
                continue
            lo, hi = w * WL, min(W, (w + 1) * WL)
            slot = int(j[w]) % A
            ring[slot, 0, :, lo:hi] = pv[:, w, :hi - lo]
            ring[slot, 1, :, lo:hi] = mv[:, w, :hi - lo]
            tag[slot, :, lo:hi] = int(j[w])
        cf = s - (A - 1)                  # whole now: one run a plane
        if 0 <= cf < Lt:
            assert bool((tag[cf % A] == cf).all())
            ppv[cf], pmv[cf] = ring[cf % A, 0], ring[cf % A, 1]
    zero = ql == 0
    return (torch.where(zero, 0, best).to(torch.int32),
            torch.where(zero, 0, bj).to(torch.int32),
            ppv.to(torch.int32), pmv.to(torch.int32))


def _inputs(seed, N, W, Lt):
    """Planted pairs at W words (Lq = 31 W), ragged qlen 0, 1, 31, 31 W - 1,
    31 W and tlen, target codes -1, 4 and 9, a query with code-4 gaps."""
    rng = np.random.default_rng(seed)
    Lq = 31 * W
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        k = min(Lq, Lt - 8)
        t[n, 4:4 + k] = q[n, :k]
        flip = rng.random(k) < 0.06
        t[n, 4:4 + k][flip] = (t[n, 4:4 + k][flip] + 1) % 4
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:5] = [0, 1, min(31, Lq), Lq - 1, Lq]
    ql[8] = min(Lq, Lt - 8)                  # a planted overlap, whole
    tl = np.full(N, Lt, np.int32)
    tl[5:8] = [0, 1, Lt // 2]
    t[1, 3:9] = -1
    t[2, 10:20] = 9
    t[3, ::5] = 4
    q[4, 2:6] = 4
    return q, t, ql, tl


@pytest.mark.parametrize("W,Lt", [(1, 60), (4, 184), (24, 200), (25, 160),
                                  (34, 120), (35, 110), (100, 80)])
def test_planes_schedule_matches_jax(W, Lt):
    """K2s's schedule (split lanes, skew, ring staging, contiguous column
    stores) = the JAX package's myers_batch_planes, dist, tend and both
    planes, bit for bit; the register route to W 34, the wide route past
    it (32 lanes, ceil(W / 32) words each)."""
    q, t, ql, tl = _inputs(W, 10, W, Lt)
    ref, rpv, rmv = JM.myers_batch_planes(*_j(q, t, ql, tl))
    got = planes_schedule(*_t(q, t, ql, tl))
    for name, g, r in zip(("dist", "tend", "pv", "mv"), got,
                          (ref.dist, ref.tend, rpv, rmv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"W {W} {name}")
    assert int(np.asarray(ref.dist)[8]) < max(ql[8] // 4, 1)


@pytest.mark.parametrize("W", [25, 35, 70])
def test_planes_wrapper_past_24_words_matches_jax(W):
    """On CPU tensors myers_batch_planes_cuda takes every W (there is no
    word cap) and equals the JAX package; no counter moves."""
    q, t, ql, tl = _inputs(100 + W, 10, W, 64)
    ref, rpv, rmv = JM.myers_batch_planes(*_j(q, t, ql, tl))
    n = spans.launches()
    got, gpv, gmv = TMC.myers_batch_planes_cuda(*_t(q, t, ql, tl))
    assert spans.launches() == n
    for g, r in ((got.dist, ref.dist), (got.tend, ref.tend), (gpv, rpv),
                 (gmv, rmv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_planes_routes(monkeypatch):
    """K2s: the register route to W 34 (group_width(W) lanes, rings in
    static shared memory), the wide route past it (32 lanes, words and
    rings in dynamic shared memory while both fit, then the words in a
    scratch, then no ring); K2 (one thread a pair) only forced, W <= 24;
    a batch whose planes device memory cannot hold raises with their bytes."""
    assert not hasattr(TMC, "PLANES_MAX_WORDS")
    for W in range(1, 35):
        r = TMC.planes_route(31 * W)
        assert r == TMC.PlanesRoute(W, TMC.group_width(W), 0, 0, False,
                                    True), W
        assert TMC.planes_counter(r) == "myers_batch_planes_cuda"
    r = TMC.planes_route(35 * 31)
    assert (r.W, r.G, r.wl, r.ring, r.words) == (35, 32, 2, True, False)
    assert r.smem == 4 * 5 * 2 * 32 * 4 + 4 * 2 * 18 * 35 * 4
    assert TMC.planes_counter(r) == "myers_batch_planes_cuda_wide"
    assert TMC.planes_route(3100).smem == 4 * 5 * 4 * 32 * 4 + \
        4 * 2 * 25 * 100 * 4
    r = TMC.planes_route(3100, words_scratch=True)
    assert r.words and r.ring and r.smem == 4 * 2 * 25 * 100 * 4
    r = TMC.planes_route(31000)                  # W 1000: no ring fits
    assert (r.wl, r.ring, r.words, r.smem) == (32, False, False,
                                               4 * 5 * 32 * 32 * 4)
    assert TMC.planes_route(744, thread=True).thread
    with pytest.raises(ValueError, match="query words"):
        TMC.planes_route(775, thread=True)
    q = torch.zeros((4, 3100), dtype=torch.int32)
    one = torch.ones(4, dtype=torch.int32)
    r, (qa, ta, *_, words), outs = TMC.planes_operands(q, q, one, one)
    assert qa is q and ta is q and words is None
    assert [tuple(o.shape) for o in outs] == [(4,), (4,), (3100, 4, 100),
                                              (3100, 4, 100)]
    _, (*_, words), _ = TMC.planes_operands(q, q, one, one,
                                            words_scratch=True)
    assert words.numel() == 4 * 5 * 4 * 32
    assert TMC.planes_bytes(4096, 100, 3172) == 2 * 3172 * 4096 * 100 * 4

    def oom(*a, **k):
        raise torch.OutOfMemoryError("out of memory")

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", oom)
        with pytest.raises(ValueError, match="10,394,009,600 bytes"):
            TMC.planes_alloc(4096, 100, 3172, torch.device("cpu"))
    assert sorted(k for k in TMC.LAUNCH_COUNTERS if "planes" in k) == [
        "myers_batch_planes_cuda", "myers_batch_planes_cuda_wide"]


@pytest.mark.cuda
def test_cuda_planes_kernel_matches_plain(cuda):
    for W, Lt, force in ((1, 60, {}), (4, 184, {}), (24, 200, {}),
                         (25, 160, {}), (34, 120, {}), (35, 110, {}),
                         (100, 80, {}), (100, 80, {"words_scratch": True}),
                         (4, 184, {"thread": True})):
        args = [x.to(cuda) for x in _t(*_inputs(W, 300, W, Lt))]
        ref = TM.myers_batch_planes(*args)
        r, ins, outs = TMC.planes_operands(*args, **force)
        TMC.run_planes_kernel(r, ins, outs)
        for g, x in zip(outs, (ref[0].dist, ref[0].tend, ref[1], ref[2])):
            assert torch.equal(g, x), (W, force)
