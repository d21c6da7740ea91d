"""The redesigned kernels K1' (csrc/myers_gate.cu) and K3' (csrc/sw.cu) on
the CPU: their schedules emulated step by step in plain PyTorch, held
exactly against the JAX package; the plain SW version against the JAX one
at K3's slot-count boundaries; the wrappers' route and geometry rules; and,
marked ``cuda``, the kernels against their plain versions on the card.

The emulations follow the kernels' own order of work, which the plain
versions do not: K1' runs word w of a pair on column s - w at step s with
word w - 1's carries from step s - 1, its query planes built per word from
the codes; K3' reads the target from the warp's reversed, -1-padded window
and zeroes out-of-band cells by per-slot bounds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hga_tpu.ops import align as JA
from hga_tpu.ops import myers as JM
from hga_tpu_torch.ops import align as TA
from hga_tpu_torch.ops import align_cuda as TAC
from hga_tpu_torch.ops import myers as TM
from hga_tpu_torch.ops import myers_cuda as TMC
from hga_tpu_torch.utils import spans

PAYLOAD = 31
M31 = (1 << 31) - 1
SW_FIELDS = ("score", "qend", "tend")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share (results do not depend on it)."""
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


# ------------------------------------------------------------------ K1'

def word_planes(q, qlen, wi):
    """The kernel's plane rule for query word wi of every pair: position
    p = 31 wi + b is valid when p < qlen and its code is < 4 (positions past
    Lq hold code 4); q0 and q1 take the code's bits 0 and 1; the end bit is
    position qlen - 1 when it falls in this word.  int64 (N,) each."""
    N, Lq = q.shape
    ql = qlen.long()
    b0 = torch.zeros(N, dtype=torch.int64)
    b1, bv = b0.clone(), b0.clone()
    for b in range(PAYLOAD):
        pos = wi * PAYLOAD + b
        code = q[:, pos].long() if pos < Lq else torch.full((N,), 4)
        ok = (pos < ql) & (code < 4)
        b0 |= torch.where(ok, (code & 1) << b, 0)
        b1 |= torch.where(ok, ((code >> 1) & 1) << b, 0)
        bv |= torch.where(ok, 1 << b, 0)
    e = torch.clamp(ql - 1, min=0)
    me = torch.where((ql > 0) & (e // PAYLOAD == wi), 1 << (e % PAYLOAD), 0)
    return b0, b1, bv, me


def gate_schedule(q, t, qlen, tlen, G):
    """K1' as the kernel schedules it: lane w of a pair's G lanes holds
    words w*WL .. w*WL + WL - 1 and runs column j = s - w at step s, taking
    the adder carry and the two shift carries that lane w - 1 left at step
    s - 1 (lane 0 takes 0); the lane that holds the end bit keeps the score,
    and lane 0 writes when none does."""
    N, Lq = q.shape
    Lt = t.shape[1]
    W = TM.n_words(Lq)
    WL = -(-W // G)
    A = -(-W // WL)
    planes = [word_planes(q, qlen, wi) for wi in range(W)]
    pv = [torch.full((N,), M31, dtype=torch.int64) for _ in range(W)]
    mv = [torch.zeros(N, dtype=torch.int64) for _ in range(W)]
    ql, tl, tt = qlen.long(), tlen.long(), t.long()
    out = [torch.zeros(N, dtype=torch.int64) for _ in range(A)]
    score = [ql.clone() for _ in range(A)]
    best = [ql.clone() for _ in range(A)]
    bj = [torch.zeros(N, dtype=torch.int64) for _ in range(A)]
    for s in range(Lt + A - 1):
        last = list(out)                     # what the shuffle reads
        for w in range(A):
            j = s - w
            if not 0 <= j < Lt:
                continue
            tc = tt[:, j]
            t0, t1 = -(tc & 1), -((tc >> 1) & 1)
            tvm = -((tc >= 0) & (tc < 4)).long()
            if w == 0:
                cin = cp = cm = torch.zeros(N, dtype=torch.int64)
            else:
                cin, cp, cm = last[w - 1] & 1, (last[w - 1] >> 1) & 1, \
                    (last[w - 1] >> 2) & 1
            pb = mb = torch.zeros(N, dtype=torch.int64)
            for k in range(WL):
                wi = w * WL + k
                q0, q1, vq, mend = planes[wi]
                eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
                xv = eq | mv[wi]
                sw = (eq & pv[wi]) + pv[wi] + cin
                cin = sw >> 31
                xh = ((sw & M31) ^ pv[wi]) | eq
                ph = mv[wi] | ~(xh | pv[wi])
                mh = pv[wi] & xh
                pb, mb = pb | (ph & mend), mb | (mh & mend)
                ncp, ncm = (ph >> 30) & 1, (mh >> 30) & 1
                ph = ((ph << 1) & M31) | cp
                mh = ((mh << 1) & M31) | cm
                cp, cm = ncp, ncm
                pv[wi] = (mh | ~(xv | ph)) & M31
                mv[wi] = ph & xv
            out[w] = cin | (cp << 1) | (cm << 2)
            score[w] = score[w] + (pb != 0).long() - (mb != 0).long()
            take = (score[w] < best[w]) & (j < tl)
            bj[w] = torch.where(take, j + 1, bj[w])
            best[w] = torch.where(take, score[w], best[w])
    e = torch.clamp(ql - 1, min=0) // PAYLOAD
    writer = torch.where((ql > 0) & (e < W), e // WL, 0)
    rows = torch.arange(N)
    b = torch.stack(best)[writer, rows]
    j = torch.stack(bj)[writer, rows]
    zero = ql == 0
    return (torch.where(zero, 0, b).to(torch.int32),
            torch.where(zero, 0, j).to(torch.int32))


# (N, Lq, Lt) by words W: ragged query widths, W 1, 2, 4, 5, 14, 24
GATE_SHAPES = {1: (40, 31, 40), 2: (40, 40, 56), 4: (40, 112, 60),
               5: (40, 128, 60), 14: (24, 414, 48), 24: (16, 744, 40)}


def _gate_inputs(seed, N, Lq, Lt):
    """Planted pairs; qlen 0, 1, 31, 32, Lq - 1 (those that fit), above Lq
    and negative; code 4 past qlen; ragged tlen (0 and Lt included); codes
    -1, 4 and 9 in queries and targets."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        L = min(Lq, Lt - 4)
        off = int(rng.integers(0, Lt - L + 1))
        seg = q[n, :L].copy()
        flip = rng.random(L) < 0.06
        seg[flip] = (seg[flip] + 1) % 4
        t[n, off:off + L] = seg
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    edge = [x for x in (0, 1, 31, 32, Lq - 1) if 0 <= x <= Lq]
    ql[:len(edge)] = edge
    ql[len(edge)] = Lq + 1
    ql[len(edge) + 1] = -1
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 4
    tl = rng.integers(0, Lt + 1, N).astype(np.int32)
    tl[:3] = [Lt, 0, Lt]
    t[:N // 2, :5] = rng.choice([-1, 4, 9], size=(N // 2, 5))
    q[N // 2:, 2:6] = rng.choice([-1, 4, 9], size=(N - N // 2, 4))
    return q, t, ql, tl


@pytest.mark.parametrize("W,G", [(W, G) for W in sorted(GATE_SHAPES)
                                 for G in sorted({1, TMC.group_width(W)})])
def test_gate_schedule_matches_jax(W, G):
    N, Lq, Lt = GATE_SHAPES[W]
    assert TM.n_words(Lq) == W
    q, t, ql, tl = _gate_inputs(100 + W, N, Lq, Lt)
    dist, tend = gate_schedule(*_t(q, t, ql, tl), G)
    ref = JM.myers_batch(*_j(q, t, ql, tl))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(tend.numpy(), np.asarray(ref.tend))
    got = TM.myers_batch(*_t(q, t, ql, tl))        # and the plain version
    assert torch.equal(got.dist, dist) and torch.equal(got.tend, tend)


def test_in_kernel_plane_rule_equals_query_planes():
    rng = np.random.default_rng(5)
    N, Lq = 64, 100                     # W 4, the last word partly padded
    W = TM.n_words(Lq)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    q[:, ::7] = rng.choice([-1, 4, 9, 2], size=(N, len(range(0, Lq, 7))))
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    ql[:8] = [0, 1, 30, 31, 32, 62, Lq, Lq + 20]
    ql[8] = -3
    rule = [torch.stack([word_planes(*_t(q, ql), wi)[k] for wi in range(W)],
                        dim=1).to(torch.int32) for k in range(4)]
    port = TM.query_planes(*_t(q, ql), W)
    ref = JM.query_planes(*_j(q, ql), W)
    for r, p, j in zip(rule, port, ref):
        assert torch.equal(r, p)
        np.testing.assert_array_equal(r.numpy(), np.asarray(j))


def test_gate_groups_and_blocks():
    assert [TMC.group_width(W) for W in (1, 2, 3, 4, 5, 8, 9, 14, 16, 17,
                                         24)] == \
        [1, 2, 4, 4, 8, 8, 16, 16, 16, 32, 32]
    assert sorted(TMC.GATE_GROUP) == list(range(1, TMC.REGISTER_MAX_WORDS
                                                + 1))
    for W, G in TMC.GATE_GROUP.items():
        assert G in (1, TMC.group_width(W)), (W, G)
    # 4096 pairs: 8 pairs a warp at G 4 (512 warps), 2 at G 16 (2048 warps)
    assert TMC.gate_blocks(4096, 4) * TMC.THREADS // 32 == 512
    assert TMC.gate_blocks(4096, 16) * TMC.THREADS // 32 == 2048
    assert TMC.gate_blocks(4096, 1) == 32
    q = torch.zeros((8, 112), dtype=torch.int32)
    one = torch.ones(8, dtype=torch.int32)
    ops = TMC.kernel_operands(q, q, one, one, group=1)
    assert ops[4][:2] == (4, 1) and ops[0] is q     # codes as given
    assert TMC.kernel_operands(q, q, one, one)[4].G == TMC.GATE_GROUP[4]
    with pytest.raises(ValueError, match="lanes"):
        TMC.kernel_operands(q, q, one, one, group=2)


# ------------------------------------------------------------------ K3'

def sw_diag_schedule(q, t, qlen, tlen, band, match=2, mismatch=-4, gap=-3):
    """K3' as the kernel runs it, vectorised over a warp's 32 K slots: the
    target from the reversed window padded with -1, cells zeroed outside
    [dlo, dhi], per-slot best with the first d (strict >), then max H, min
    d, min slot.  Asserts that no unmasked cell reads the padding."""
    N, Lq = q.shape
    Lt = t.shape[1]
    band = min(band, max(Lq, Lt))
    K = TAC.slots_per_lane(Lq)
    Lqp = 32 * K
    win = Lt + 2 * Lqp
    u = Lt - 1 + Lqp - torch.arange(win)
    pad = (u < 0) | (u >= Lt)
    window = torch.where(pad, -1, t[:, u.clamp(0, max(Lt - 1, 0))]) \
        if Lt else torch.full((N, win), -1, dtype=torch.int32)
    p = torch.arange(Lqp)
    i = p + 1
    qv = torch.zeros((N, Lqp), dtype=torch.int32)
    qv[:, :Lq] = q
    ql = qlen.long().clamp(0, Lq)[:, None]
    tl = torch.clamp(tlen.long(), max=Lt)[:, None]
    dlo = i + torch.clamp(i - band, min=1)
    dhi = torch.where(i <= ql, i + torch.minimum(tl, i + band), -1)
    dend = torch.where(ql[:, 0] >= 1, ql[:, 0] + torch.minimum(
        tl[:, 0], ql[:, 0] + band), 1)
    z = torch.zeros((N, Lqp), dtype=torch.int64)
    ad1, s2, bv, bd = z, z, z, z.clone()
    for d in range(2, int(dend.max()) + 1):
        s1 = torch.cat([z[:, :1], ad1[:, :-1]], dim=1)
        y = Lt + 1 + Lqp + p - d
        assert int(y.min()) >= 0 and int(y.max()) < win
        inband = (d >= dlo) & (d <= dhi) & (d <= dend[:, None])
        assert not bool((inband & pad[y][None, :]).any())
        sub = torch.where(qv == window[:, y], match, mismatch)
        v = torch.clamp(torch.maximum(s2 + sub, torch.maximum(ad1, s1) + gap),
                        min=0)
        v = torch.where(inband, v, 0)
        better = v > bv
        bv = torch.where(better, v, bv)
        bd = torch.where(better, d, bd)
        s2, ad1 = s1, v
    vmax = bv.max(dim=1, keepdim=True).values
    dmin = torch.where(bv == vmax, bd, 1 << 30).min(dim=1,
                                                     keepdim=True).values
    pmin = torch.where((bv == vmax) & (bd == dmin), p, Lqp).min(dim=1).values
    vmax, dmin = vmax[:, 0], dmin[:, 0]
    has = vmax > 0
    qend = torch.where(has, pmin + 1, 0)
    return (vmax.to(torch.int32), qend.to(torch.int32),
            torch.where(has, dmin - qend, 0).to(torch.int32))


def _sw_inputs(seed, N, Lq, Lt, band):
    """Planted pairs with ragged lengths (0 and full included), -1 codes in
    queries and targets (the window's padding value: they must never meet
    it on a counted cell), rows of -1 only, homopolymers and ACAC...
    repeats (ties on many cells and slots)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(N):
        lead = int(rng.integers(0, max(1, min(band, Lt) // 2 + 1)))
        seg = q[n, : Lt - lead].copy()
        flip = rng.random(seg.size) < 0.08
        seg[flip] = (seg[flip] + 1) % 4
        t[n, lead:lead + seg.size] = seg
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    tl = rng.integers(0, Lt + 1, N).astype(np.int32)
    ql[:3], tl[:3] = [0, Lq, Lq], [Lt, 0, Lt]
    q[3, ::3], t[3, : Lt // 2] = -1, -1
    q[4], t[4] = -1, -1
    q[5], t[5] = 0, 0
    q[6, ::2], q[6, 1::2] = 0, 1
    t[6, ::2], t[6, 1::2] = 1, 0
    ql[3:7], tl[3:7] = Lq, Lt
    return q, t, ql, tl


@pytest.mark.parametrize("Lq", [1, 31, 32, 33, 112, 128, 129, 256])
def test_sw_diag_schedule_matches_plain(Lq):
    """Each Lq at four bands; the plain version is held against JAX by
    test_torch_align.py and the boundary test below."""
    Lt = Lq + 40
    for band in (0, 64, 128, Lq + 7):
        q, t, ql, tl = _t(*_sw_inputs(Lq + band, 24, Lq, Lt, band))
        got = sw_diag_schedule(q, t, ql, tl, band)
        ref = TA.banded_sw_batch(q, t, ql, tl, band=band)
        assert int(ref.score.max()) > 0
        for f, g in zip(SW_FIELDS, got):
            assert torch.equal(g, getattr(ref, f)), (band, f)


@pytest.mark.parametrize("band", [0, 64, 128, "ge"])
@pytest.mark.parametrize("Lq", [32, 33, 128, 129, 256, 257])
def test_sw_plain_matches_jax_at_slot_boundaries(Lq, band):
    band = Lq + 5 if band == "ge" else band
    Lt = Lq + 24
    q, t, ql, tl = _sw_inputs(7 * Lq + band, 10, Lq, Lt, band)
    ref = JA.banded_sw_batch(*_j(q, t, ql, tl), band=band)
    got = TA.banded_sw_batch(*_t(q, t, ql, tl), band=band)
    assert int(np.asarray(ref.score).max()) > 0
    for f in SW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # the route the card takes at this shape: K3'' above Lq 256 while the
    # clamped band + 1 <= 256, K3''' past that (Lq 257, band >= Lq)
    wide = "band" if min(band, max(Lq, Lt)) < 256 else "wide"
    assert TAC.route(Lq, Lt, band).kind == ("diag" if Lq <= 256 else wide)


def test_sw_routes_and_geometry():
    assert [TAC.slots_per_lane(lq) for lq in (0, 1, 32, 33, 64, 65, 128,
                                              129, 256, 257)] == \
        [1, 1, 1, 2, 2, 4, 4, 8, 8, None]
    # the refine's shapes: K 4, 4 warps, a window of Lt + 256 int32 each
    for band in (64, 128):
        r = TAC.route(112, 184, band)
        assert r == TAC.Route("diag", 4, 4, 4 * (184 + 256) * 4, False)
    assert TAC.diag_smem_bytes(184, 4, 4) == 7040
    # long targets: fewer warps a block, then the band route (K3''), whose
    # windows do not grow with the target
    assert TAC.route(100, 28000, 64)[:3] == ("diag", 4, 2)
    assert TAC.route(100, 57000, 64)[:3] == ("diag", 4, 1)
    assert TAC.route(100, 58000, 64)[:2] == ("band", 3)
    # Lq above 256 takes the band route up to a clamped band of 255, then
    # K3''' (two warps a pair at band 256); the forced row route keeps its
    # buffer in shared memory up to band 907, then the device scratch
    assert TAC.route(257, 300, 64)[:2] == ("band", 3)
    assert TAC.route(257, 300, 256) == TAC.Route("wide", 5, 2, 3600, False,
                                                 2)
    assert TAC.rows_route(257, 300, 256) == TAC.Route(
        "rows", 0, 0, (2 * 256 + 2) * 32 * 4, False)
    assert TAC.rows_route(1000, 1000, 907).scratch is False
    assert TAC.rows_route(1000, 1000, 908).scratch is True
    assert TAC.rows_route(300, 200, 5000).smem == (2 * 300 + 2) * 32 * 4
    assert TAC.route(300, 200, 5000)[:2] == ("wide", 5)
    q = torch.zeros((4, 112), dtype=torch.int32)
    t = torch.zeros((4, 184), dtype=torch.int32)
    n = torch.ones(4, dtype=torch.int32)
    r, qa, ta, *_, band, scratch, outs = TAC.kernel_operands(q, t, n, n, 500)
    assert r.kind == "diag" and qa is q and ta is t and band == 184
    r, qa, ta, *_ = TAC.kernel_operands(q, t, n, n, 64, kind="rows")
    assert r.kind == "rows" and qa.shape == (112, 4) and ta.shape == (184, 4)
    assert TAC.ROUTE_COUNTER == {"diag": "banded_sw_batch_cuda",
                                 "band": "banded_sw_batch_cuda_band",
                                 "wide": "banded_sw_batch_cuda_wide",
                                 "rows": "banded_sw_batch_cuda_rows"}


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_cuda_gate_kernel_matches_plain_both_designs(cuda):
    for W, (N, Lq, Lt) in sorted(GATE_SHAPES.items()):
        args = [x.to(cuda) for x in _t(*_gate_inputs(W, 4 * N, Lq, Lt))]
        ref = TM.myers_batch(*args)
        for G in sorted({1, TMC.group_width(W)}):
            *ops, outs = TMC.kernel_operands(*args, group=G)
            TMC.run_kernel(*ops, outs)
            assert torch.equal(outs[0], ref.dist), (W, G)
            assert torch.equal(outs[1], ref.tend), (W, G)
        n = spans.launches()["myers_batch_cuda"]
        got = TMC.myers_batch_cuda(*args)
        assert spans.launches()["myers_batch_cuda"] == n + 1
        assert torch.equal(got.dist, ref.dist)


@pytest.mark.cuda
def test_cuda_sw_routes_match_plain(cuda):
    for Lq in (1, 31, 33, 112, 129, 256, 257, 300):
        for band in (0, 64, 128, Lq + 7):
            Lt = Lq + 40
            args = [x.to(cuda) for x in _t(*_sw_inputs(Lq, 300, Lq, Lt,
                                                        band))]
            key = TAC.ROUTE_COUNTER[TAC.route(Lq, Lt, band).kind]
            n = spans.launches()[key]
            got = TAC.banded_sw_batch_cuda(*args, band=band)
            assert spans.launches()[key] == n + 1
            ref = TA.banded_sw_batch(*args, band=band)
            for f in SW_FIELDS:
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    (Lq, band, f)
